"""Ring all-reduce over the ranks of a single-device mesh: the wrapper of
kernel K5 in csrc/ring.cu (counterpart of hgnn2_tpu/ops/pallas/ring.py).

ring_psum(parts) takes one float32 tensor per rank and returns, for every
rank r, ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-S+1}: the TPU kernel's
summation order. ring_psum_reference repeats the TPU kernel's hop
schedule in PyTorch and so defines that order; the kernel reads the S
inputs once in the same order, and the two agree bit for bit.

For CUDA tensors ring_psum launches one kernel a call (on the current
stream) and adds one to its ``launches`` count; a kernel that cannot
build or launch raises. For CPU tensors it runs
ring_psum_reference. Like the JAX package's ring, it has no gradient: it
refuses a tensor that requires grad while grad mode is on.

ProcessRing is K5 across processes: one rank a process, each process
holding its own partial and keeping its own rank's sum, bit-equal to
ring_psum_reference(all parts)[r] (csrc/ring.cu:ring_reduce_rank over
slots that the processes map into each other over CUDA IPC). Its plain
version, process_ring_reference, gathers the parts over the process
group; it is what runs on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from hgnn2_torch.ops import cuda_build

MAX_RANKS = 8  # the kernel's by-value pointer table; the JAX tests' largest mesh


# the ring library's C entries in csrc/ring.cu: (name, argtypes), for
# cuda_build.entry; K5 within a process, then K5 across processes and the
# CUDA IPC calls that map their slots
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_ALLREDUCE = ("hgnn2_ring_allreduce", [_PP, _PP, _I, _LL, _VP])
_REDUCE_RANK = ("hgnn2_ring_reduce_rank", [_PP, _VP, _I, _I, _LL, _VP])
_IPC = {"hgnn2_ipc_handle_bytes": [],
        "hgnn2_ipc_alloc": [_I, _LL, _PP],
        "hgnn2_ipc_export": [_I, _VP, ctypes.c_char_p],
        "hgnn2_ipc_open": [_I, ctypes.c_char_p, _PP],
        "hgnn2_ipc_close": [_I, _VP],
        "hgnn2_ipc_free": [_I, _VP],
        "hgnn2_ipc_copy": [_VP, _VP, _LL, _VP]}


def _ipc(name: str) -> ctypes._CFuncPtr:
    return cuda_build.entry("ring", name, _IPC[name])


def ring_psum_reference(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ring's hop schedule in PyTorch: on hop h every rank forwards
    the block it received on hop h - 1 (its own on hop 0) to its right
    neighbour and adds the block it receives into its output."""
    S = len(parts)
    out = list(parts)
    send = list(parts)
    for _ in range(S - 1):
        send = [send[(r - 1) % S] for r in range(S)]
        out = [out[r] + send[r] for r in range(S)]
    return out


def _check(parts: list[torch.Tensor]) -> None:
    if not parts:
        raise ValueError("ring_psum needs at least one rank")
    x0 = parts[0]
    for r, x in enumerate(parts):
        if x.shape != x0.shape or x.dtype != torch.float32:
            raise ValueError(
                f"rank {r}: every part must be float32 of shape "
                f"{tuple(x0.shape)}; got {x.dtype} {tuple(x.shape)}")
        if x.device != x0.device:
            raise NotImplementedError(
                f"rank {r} is on {x.device}, rank 0 on {x0.device}: a ring "
                "across devices runs one rank a process (ProcessRing)")
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "ring_psum has no gradient (nor has the JAX package's ring): "
                "call it under torch.no_grad(), or use the plain reduce")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")


def ring_psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce sum of S rank buffers; S = 1 returns the input as is."""
    _check(parts)
    S = len(parts)
    if S == 1:
        return list(parts)
    x0 = parts[0]
    if x0.device.type == "cpu":
        return ring_psum_reference(parts)
    if S > MAX_RANKS:
        raise ValueError(f"the ring kernel takes at most {MAX_RANKS} ranks; got {S}")
    parts = [x.contiguous() for x in parts]
    n = x0.numel()
    out = torch.empty((S,) + tuple(x0.shape), dtype=torch.float32,
                      device=x0.device)
    ins = (ctypes.c_void_p * S)(*[x.data_ptr() for x in parts])
    outs = (ctypes.c_void_p * S)(*[out[r].data_ptr() for r in range(S)])
    cuda_build.launch(cuda_build.entry("ring", *_ALLREDUCE), x0.device, ins,
                      outs, S, n)
    ring_psum.launches += 1
    return list(out.unbind(0))


ring_psum.launches = 0


def gather_parts(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every process's x over ``group``, in rank order (through the host
    for gloo on a card: gloo gathers CPU tensors)."""
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    mine = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return parts


def process_ring_reference(x: torch.Tensor, group=None) -> torch.Tensor:
    """The plain version of ProcessRing: every process's part gathered
    over ``group``, then this process's rank of ring_psum_reference, on
    x's device."""
    _check([x])
    if dist.get_world_size(group) == 1:
        return x
    parts = gather_parts(x, group)
    return ring_psum_reference(parts)[dist.get_rank(group)].to(x.device)


class ProcessRing:
    """K5 across the processes of ``group``, one rank a process: a call
    with this process's partial x returns its rank r's ring sum
    ((x_r + x_{r-1}) + ...) + x_{r-S+1}, bit-equal to
    ring_psum_reference(parts)[r]. Every process of the group calls it
    in the same order with tensors of the same shape (SPMD). On the CPU a
    call is process_ring_reference; on a card it is one launch of
    csrc/ring.cu:ring_reduce_rank (ProcessRing.launches counts them, apart
    from ring_psum's), on the current stream. No gradient: it refuses a
    tensor that requires grad in grad mode, as the JAX ring has no VJP.

    The slots. At its first call (and whenever a larger x arrives) every
    process allocates one block of two slots of n floats with its own
    cudaMalloc, exports its IPC handle, gathers the group's handles
    (all_gather_object) and opens every peer's; it reads its own slots
    through its own pointer. Call c runs:
      1. copy x into this process's slot c % 2, on the current stream;
      2. synchronize that stream and the previous call's launch;
      3. barrier on the group;
      4. launch the kernel over the S ranks' slot c % 2;
      5. return this rank's sum (the launch is asynchronous).
    Why no write meets a read: the kernel of call c on any process p
    reads the slots c % 2 of every process; process q next writes its
    slot c % 2 in call c + 2, after the barrier of call c + 1; p reaches
    that barrier only after step 2 of call c + 1, which waits for its
    kernel of call c. A peer's write of slot (c + 1) % 2 in call c + 1
    touches the other slot. Step 1's copy has finished on every process
    before step 3 lets any process launch. Growing the slots and close()
    synchronize, then barrier before every process closes its peers'
    handles and again before each frees its own block. The host barrier
    after a stream sync cannot deadlock on processes that time-slice one
    card, as a kernel spinning on a peer's flag could.

    ``comm`` counts the calls and the bytes each process reads from its
    peers' slots ((S - 1) n 4 a call)."""

    launches = 0

    def __init__(self, group=None):
        self.group = group
        self.calls = 0
        self.comm = {"ring_calls": 0, "ring_bytes": 0}
        self._cap = 0  # floats a slot
        self._dev = None  # the card's index
        self._own = None  # this process's block: slot 0, then slot 1
        self._ptrs: list[int] = []  # every rank's block, in rank order
        self._filled = 0  # the slot the latest call filled
        self._last = None  # the event after the latest launch

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        _check([x])
        if self.size == 1:
            return x
        if x.device.type == "cpu":
            out = process_ring_reference(x, self.group)
        else:
            out = self._stage(x)
            self.reduce(x.numel(), out)
        self.calls += 1
        self.comm["ring_calls"] += 1
        self.comm["ring_bytes"] += (self.size - 1) * x.numel() * 4
        return out

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """Steps 1-3 of a call; returns the output tensor, to be filled."""
        if self.size > MAX_RANKS:
            raise ValueError(f"the ring kernel takes at most {MAX_RANKS} "
                             f"ranks; got {self.size}")
        x = x.contiguous()
        n = x.numel()
        with torch.cuda.device(x.device):
            if n > self._cap:
                self._grow(n, x)
            stream = torch.cuda.current_stream(x.device)
            self._filled = self.calls % 2
            cuda_build.check(_ipc("hgnn2_ipc_copy")(
                self._slot(self._own, self._filled), x.data_ptr(), n * 4,
                stream.cuda_stream), "hgnn2_ipc_copy")
            stream.synchronize()
            if self._last is not None:
                self._last.synchronize()
            dist.barrier(group=self.group)
        return torch.empty_like(x)

    def reduce(self, n: int, out: torch.Tensor) -> None:
        """Step 4: one launch over the S ranks' slots of the latest call,
        this rank's sum of their first n floats into ``out`` (CUDA,
        contiguous). A caller that times the kernel alone calls this again
        after a call, before the next one; the next call waits for it."""
        S = self.size
        ins = (ctypes.c_void_p * S)(*[self._slot(p, self._filled)
                                      for p in self._ptrs])
        cuda_build.launch(cuda_build.entry("ring", *_REDUCE_RANK), out.device,
                          ins, out.data_ptr(), S, self.rank, n)
        ProcessRing.launches += 1
        self._last = torch.cuda.Event()
        self._last.record(torch.cuda.current_stream(out.device))

    def _slot(self, block: int, k: int) -> int:
        return block + k * self._cap * 4

    def _grow(self, n: int, x: torch.Tensor) -> None:
        """Every process's two slots of n floats (rounded up to 64), the
        old ones released first, the group's handles exchanged."""
        dev = (x.device.index if x.device.index is not None
               else torch.cuda.current_device())
        self.close()
        cap = -(-n // 64) * 64
        own = ctypes.c_void_p()
        cuda_build.check(_ipc("hgnn2_ipc_alloc")(dev, 2 * cap * 4,
                                                 ctypes.byref(own)),
                         "hgnn2_ipc_alloc")
        handle = ctypes.create_string_buffer(_ipc("hgnn2_ipc_handle_bytes")())
        cuda_build.check(_ipc("hgnn2_ipc_export")(dev, own, handle),
                         "hgnn2_ipc_export")
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw, group=self.group)
        ptrs = []
        for k, h in enumerate(handles):
            if k == self.rank:
                ptrs.append(own.value)
                continue
            peer = ctypes.c_void_p()
            cuda_build.check(_ipc("hgnn2_ipc_open")(dev, h, ctypes.byref(peer)),
                             f"hgnn2_ipc_open of rank {k}'s slots")
            ptrs.append(peer.value)
        self._own, self._ptrs, self._cap, self._dev = own.value, ptrs, cap, dev

    def close(self) -> None:
        """Releases the slots: every process of the group calls it (the
        owner frees its block only after every peer has closed it)."""
        if self._own is None:
            return
        torch.cuda.synchronize(self._dev)
        dist.barrier(group=self.group)
        for k, p in enumerate(self._ptrs):
            if k != self.rank:
                cuda_build.check(_ipc("hgnn2_ipc_close")(self._dev, p),
                                 "hgnn2_ipc_close")
        dist.barrier(group=self.group)
        cuda_build.check(_ipc("hgnn2_ipc_free")(self._dev, self._own),
                         "hgnn2_ipc_free")
        self._own, self._ptrs, self._cap, self._last = None, [], 0, None
