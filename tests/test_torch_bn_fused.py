"""MaskedBatchNorm's train-mode kernels (hgnn2_torch/ops/bn_fused.py,
csrc/bn_fused.cu) and the rule that picks them.

On the CPU: the plain backward formulas (bn_fused.backward_reference)
against autograd through the composition (bn_fused.composed) in float64,
to 1e-10, for inputs of rank 3 and 2, F in {2, 5, 64}, both compat
configurations (0-d scale and bias, unmasked output) and an all-padding
batch; the autograd Function on the CPU (whose wrappers run those plain
versions) by gradcheck and against the module; the running-buffer update;
the dispatch rule.

On the card (marked requires_cuda; each skips without a card): the kernels
against the composition at the GNN cell's shapes (1,024 x 16 and 1,024 x
32 rows of F = 2), looped and tiled shapes (F = 128, 1,030) and an odd F,
with 0/1 and with soft masks, inside a captured and
replayed CUDA graph, and through make_bn_recalibration; one GNNLineGraph
train step at the benchmark's line-graph cell's smallest and largest
shape groups (2,048 molecules at node/edge buckets 16/32 and 32/64: its
edge norms and the larger node norm take the looped kernels); the module in
float64, in eval mode and with pooled statistics on the card, which
launches neither kernel and gives the composition's bits. The file imports
the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_bn_fused.py -q

Tolerances on the card: the two sum in another order in float32 (the
kernel per thread, per block, then per cluster), and that is their only
difference: each elementwise step rounds alike, so from the kernel's own
statistics the composition's elementwise ops give the kernel's output bit
for bit. Statistics and outputs are held to FWD_RTOL, gradients, whose
mean term is a difference of sums, to GRAD_RTOL, each times the largest
|value| of the tensor compared.
"""

import re

import pytest
import torch

from hgnn2_torch.nn import layers
from hgnn2_torch.ops import bn_fused

COMPATS = {"default": layers.CompatConfig(),
           "reference": layers.CompatConfig.reference()}
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _inputs(shape, compat, dtype=torch.float64, device="cpu", seed=0,
            mask="binary"):
    """h (shape), a mask (shape[:-1]): 0/1 with about a third padding,
    all 0 ("empty") or weights in (0, 1) ("soft"); scale and bias (0-d
    under scalar_affine_bn), running mean and std."""
    gen = torch.Generator().manual_seed(seed)
    F = shape[-1]
    h = torch.randn(shape, generator=gen, dtype=torch.float64) * 1.5 + 0.3
    m = (torch.rand(shape[:-1], generator=gen) < 0.65).double()
    if mask == "empty":
        m.zero_()
    elif mask == "soft":
        m = torch.rand(shape[:-1], generator=gen, dtype=torch.float64)
    pshape = () if compat.scalar_affine_bn else (F,)
    scale = torch.randn(pshape, generator=gen, dtype=torch.float64)
    bias = torch.randn(pshape, generator=gen, dtype=torch.float64)
    run_mean = torch.randn(F, generator=gen, dtype=torch.float64)
    run_std = torch.rand(F, generator=gen, dtype=torch.float64) + 0.5
    return [t.to(dtype=dtype, device=device)
            for t in (h, m, scale, bias, run_mean, run_std)]


def _composed_grads(h, m, scale, bias, run_mean, run_std, g, mask_out):
    """The composition's output, batch statistics and the gradients of
    <out, g> for h, scale and bias by autograd."""
    h, scale, bias = (t.detach().clone().requires_grad_() for t in (h, scale, bias))
    out, stats = bn_fused.composed(h, m, scale, bias, run_mean.clone(),
                                   run_std.clone(), 0.1, 1e-5, mask_out)
    out.backward(g)
    return out.detach(), stats, (h.grad, scale.grad, bias.grad)


SHAPES = [(3, 7, 2), (3, 7, 5), (3, 7, 64), (40, 2), (40, 5), (40, 64)]


@pytest.mark.parametrize("compat", list(COMPATS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask", ["binary", "empty", "soft"])
def test_backward_formulas_match_autograd(shape, compat, mask):
    """The soft mask exercises the mean's path through the std (the C
    term), which vanishes for a 0/1 mask: there sum d m^2 = sum d = 0."""
    cfg = COMPATS[compat]
    h, m, scale, bias, rm, rs = _inputs(shape, cfg, mask=mask)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    _, (mean, std, count), want = _composed_grads(h, m, scale, bias, rm, rs, g,
                                                  cfg.mask_bn_output)
    if mask == "empty":
        assert float(count) == 1.0  # the count is clamped to 1
    got = bn_fused.backward_reference(g, h, m, scale, mean.detach(),
                                      std.detach(), count, cfg.mask_bn_output)
    for name, a, b in zip(("g_h", "g_scale", "g_bias"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("compat", list(COMPATS))
@pytest.mark.parametrize("shape", [(2, 5, 3), (11, 4)])
def test_function_gradcheck_on_cpu(shape, compat):
    """The autograd Function, whose wrappers run the plain versions on the
    CPU: its backward against finite differences of its forward."""
    cfg = COMPATS[compat]
    h, m, scale, bias, rm, rs = _inputs(shape, cfg)
    h, scale, bias = (t.requires_grad_() for t in (h, scale, bias))
    fn = lambda h, scale, bias: bn_fused.masked_batch_norm(
        h, m, scale, bias, rm, rs, 0.1, 1e-5, cfg.mask_bn_output)
    assert torch.autograd.gradcheck(fn, (h, scale, bias))


@pytest.mark.parametrize("compat", list(COMPATS))
def test_running_buffers_update(compat):
    """running <- (1 - momentum) batch + momentum running, through the
    wrapper, with the statistics it returns: mean, std, clamped count."""
    cfg = COMPATS[compat]
    h, m, scale, bias, rm, rs = _inputs((4, 6, 2), cfg)
    rm0, rs0 = rm.clone(), rs.clone()
    _, stats = bn_fused.bn_forward(h, m, scale, bias, rm, rs, 0.1, 1e-5,
                                   cfg.mask_bn_output)
    mc = m[..., None]
    count = m.sum().clamp_min(1.0)
    mean = (h * mc).sum(dim=(0, 1)) / count
    std = torch.sqrt(1e-5 + (((h * mc - mean) * mc) ** 2).sum(dim=(0, 1)) / count)
    torch.testing.assert_close(stats, torch.cat([mean, std, count.reshape(1)]))
    torch.testing.assert_close(rm, 0.9 * mean + 0.1 * rm0)
    torch.testing.assert_close(rs, 0.9 * std + 0.1 * rs0)


@pytest.mark.parametrize("device, dtype, training, axis, want", [
    ("cuda", torch.float32, True, None, True),
    ("cpu", torch.float32, True, None, False),
    ("cuda", torch.float64, True, None, False),
    ("cuda", torch.float32, False, None, False),
    ("cuda", torch.float32, True, "edge", False),
    ("cuda", torch.float32, True, ("data", "edge"), False),
])
def test_dispatch_rule(device, dtype, training, axis, want):
    assert bn_fused.use_kernel(torch.device(device), dtype, training, axis) is want


@pytest.mark.parametrize("compat", list(COMPATS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_kernel_path_matches_composition_on_cpu(monkeypatch, compat,
                                                       dtype):
    """MaskedBatchNorm with the rule forced to the kernel path (whose
    wrappers run the plain versions on the CPU) against its composition:
    outputs, running buffers and gradients equal; bf16 input computes in
    float32 and returns bf16 on both paths."""
    cfg = COMPATS[compat]
    runs = []
    for forced in (False, True):
        monkeypatch.setattr(bn_fused, "use_kernel",
                            lambda *a, forced=forced: forced)
        bn = layers.MaskedBatchNorm(6, compat=cfg,
                                    generator=torch.Generator().manual_seed(2))
        h = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(3))
        h = h.to(dtype).requires_grad_()
        mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                            dtype=torch.float32)
        out = bn(h, mask)
        out.float().pow(2).sum().backward()
        runs.append((out.detach(), bn.mean.clone(), bn.std.clone(), h.grad,
                     bn.scale.grad, bn.bias.grad))
    for a, b in zip(*runs):
        # bf16 gradients may round one ulp apart: assert_close's bf16 default
        tol = {} if a.dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(a, b, **tol)
    assert runs[0][0].dtype == dtype


def test_module_takes_the_composition_off_the_kernel_path(monkeypatch):
    """On the CPU, in float64, in eval mode and with pooled statistics the
    module never calls the kernels' wrappers."""
    def refuse(*a, **k):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(bn_fused, "bn_forward", refuse)
    monkeypatch.setattr(bn_fused, "bn_backward", refuse)
    bn = layers.MaskedBatchNorm(4)
    mask = torch.ones(2, 3)
    for dtype in (torch.float32, torch.float64):
        h = torch.randn(2, 3, 4, dtype=dtype, requires_grad=True)
        bn.train()(h, mask).sum().backward()
        bn.eval()(h, mask)


@pytest.mark.parametrize("bad, msg", [
    ("mask", "mask must be"), ("scale", "scale must be"),
    ("dtype", "is torch.float32"), ("stats", "stats must be"),
])
def test_wrappers_refuse_bad_inputs(bad, msg):
    h, m, scale, bias, rm, rs = _inputs((5, 3), COMPATS["default"])
    if bad == "mask":
        m = m[:4]
    elif bad == "scale":
        scale = scale[:2]
    elif bad == "dtype":
        bias = bias.float()
    if bad == "stats":
        with pytest.raises(ValueError, match=msg):
            bn_fused.bn_backward(h, h, m, scale, torch.zeros(3, dtype=h.dtype),
                                 True)
        return
    with pytest.raises((ValueError, TypeError), match=msg):
        bn_fused.bn_forward(h, m, scale, bias, rm, rs, 0.1, 1e-5, True)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _close(name, got, want, rtol):
    got, want = got.detach(), want.detach()
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert torch.isfinite(got).all(), name
    assert err <= rtol * max(scale, 1e-30), (
        f"{name}: max err {err:.3e} over {rtol} x max |value| {scale:.3e}")


CARD_SHAPES = {"gnn_N16": (1024, 16, 2), "gnn_N32": (1024, 32, 2),
               "looped_F128": (64, 32, 128), "tiled_F1030": (40, 1030),
               "odd_F5": (333, 5)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mask", ["binary", "soft"])
@pytest.mark.parametrize("compat", list(COMPATS))
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernels_match_composition_on_the_card(cuda, shape, compat, mask):
    cfg = COMPATS[compat]
    h, m, scale, bias, rm, rs = _inputs(CARD_SHAPES[shape], cfg, torch.float32,
                                        cuda, mask=mask)
    g = torch.randn(h.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    want, (mean, std, count), grads = _composed_grads(h, m, scale, bias, rm, rs,
                                                      g, cfg.mask_bn_output)
    rm_k, rs_k = rm.clone(), rs.clone()
    launches = bn_fused.bn_forward.launches, bn_fused.bn_backward.launches
    hk, sk, bk = (t.clone().requires_grad_() for t in (h, scale, bias))
    out = bn_fused.masked_batch_norm(hk, m, sk, bk, rm_k, rs_k, 0.1, 1e-5,
                                     cfg.mask_bn_output)
    out.backward(g)
    torch.cuda.synchronize()
    assert (bn_fused.bn_forward.launches, bn_fused.bn_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    _, stats = bn_fused.bn_forward(h, m, scale, bias, rm.clone(), rs.clone(),
                                   0.1, 1e-5, cfg.mask_bn_output)
    F = h.shape[-1]
    _close("mean", stats[:F], mean, FWD_RTOL)
    _close("std", stats[F:2 * F], std, FWD_RTOL)
    _close("count", stats[2 * F:], count.reshape(1), FWD_RTOL)
    _close("out", out, want, FWD_RTOL)
    rm_c, rs_c = rm.clone(), rs.clone()
    bn_fused.composed(h, m, scale, bias, rm_c, rs_c, 0.1, 1e-5,
                      cfg.mask_bn_output)
    _close("running mean", rm_k, rm_c, FWD_RTOL)
    _close("running std", rs_k, rs_c, FWD_RTOL)
    for name, got, w in zip(("g_h", "g_scale", "g_bias"),
                            (hk.grad, sk.grad, bk.grad), grads):
        assert got.shape == w.shape, name
        _close(name, got, w, GRAD_RTOL)
    # from the kernel's statistics the composition's elementwise ops give
    # the kernel's bits
    mc = m[..., None]
    exact = scale * ((h * mc - stats[:F]) / stats[F:2 * F]) + bias
    if cfg.mask_bn_output:
        exact = exact * mc
    assert torch.equal(out.detach(), exact)


@pytest.mark.requires_cuda
def test_kernels_in_a_captured_graph(cuda):
    """A BN's forward and backward captured in a CUDA graph and replayed on
    new inputs give the eager kernels' bits (the sums' order is fixed)."""
    bn = layers.MaskedBatchNorm(2, generator=torch.Generator().manual_seed(1)).to(cuda)
    h_in = torch.zeros(1024, 32, 2, device=cuda, requires_grad=True)
    m_in = torch.zeros(1024, 32, device=cuda)
    g_in = torch.zeros(1024, 32, 2, device=cuda)

    def body():
        bn.scale.grad = bn.bias.grad = h_in.grad = None
        out = bn(h_in, m_in)
        out.backward(g_in)
        return out

    gen = torch.Generator(cuda).manual_seed(6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = bn_fused.bn_forward.launches
    with torch.cuda.graph(graph):
        out_g = body()
    assert bn_fused.bn_forward.launches == launches + 1
    grads = h_in.grad, bn.scale.grad, bn.bias.grad
    for _ in range(3):
        h = torch.randn(h_in.shape, device=cuda, generator=gen)
        m = (torch.rand(m_in.shape, device=cuda, generator=gen) < 0.6).float()
        g = torch.randn(g_in.shape, device=cuda, generator=gen)
        with torch.no_grad():
            h_in.copy_(h), m_in.copy_(m), g_in.copy_(g)
        run = (bn.mean.clone(), bn.std.clone())
        graph.replay()
        replayed = [out_g.clone(), *(t.clone() for t in grads), bn.mean.clone(),
                    bn.std.clone()]
        with torch.no_grad():
            bn.mean.copy_(run[0]), bn.std.copy_(run[1])
        eager = [body().detach(), h_in.grad, bn.scale.grad, bn.bias.grad,
                 bn.mean, bn.std]
        torch.cuda.synchronize()
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_recalibration_through_the_kernel(cuda, monkeypatch):
    """make_bn_recalibration's no-grad train forwards, captured, through
    the kernel against the same with the rule forced to the composition.
    GNNSimple with the GRU update: its layers run the batch norm as a
    module (without the GRU the power layer's own kernels take it)."""
    from hgnn2_torch.data import batching, qm9
    from hgnn2_torch.nn import models
    from hgnn2_torch.training import train

    recs = qm9.synthetic_qm9_like(96, seed=5)
    batches = list(batching.DenseLoader(recs, 16, task=0, device=cuda))
    groups = train.group_stacked_batches(batches)
    results = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(bn_fused, "use_kernel", lambda *a: False)
        model = models.GNNSimple(in_features=5, n_features=2, n_layers=3,
                                 gru=True,
                                 generator=torch.Generator().manual_seed(0)).to(cuda)
        launches = bn_fused.bn_forward.launches
        train.recalibrate_bn(model, groups=groups)
        assert (bn_fused.bn_forward.launches > launches) is kernel
        results.append({k: v.clone() for k, v in model.state_dict().items()})
    for k, v in results[1].items():
        _close(k, results[0][k], v, FWD_RTOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["float64_train", "float32_eval", "axis_name"])
def test_module_off_the_kernel_path_on_the_card(cuda, case):
    """On the card, MaskedBatchNorm in float64, in eval mode and with
    pooled statistics (axis_name; outside a grid the pool is this
    process's own input) launches neither kernel, and its output,
    gradients and running buffers are the composition's bits."""
    dtype = torch.float64 if case == "float64_train" else torch.float32
    training = case != "float32_eval"
    bn = layers.MaskedBatchNorm(
        2, axis_name="edge" if case == "axis_name" else None,
        generator=torch.Generator().manual_seed(8)).to(cuda).train(training)
    h, m, _, _, run_mean, run_std = _inputs((1024, 16, 2), COMPATS["default"],
                                            dtype, cuda)
    with torch.no_grad():
        bn.mean.copy_(run_mean), bn.std.copy_(run_std)
    g = torch.randn(h.shape, dtype=dtype, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(9))
    rm, rs = bn.mean.clone(), bn.std.clone()
    sp, bp = (t.detach().clone().requires_grad_() for t in (bn.scale, bn.bias))
    hp = h.clone().requires_grad_()
    want, _ = bn_fused.composed(hp, m, sp, bp, rm, rs, bn.momentum, bn.eps,
                                bn.compat.mask_bn_output, training=training)
    want.backward(g)
    launches = bn_fused.bn_forward.launches, bn_fused.bn_backward.launches
    h.requires_grad_()
    out = bn(h, m)
    out.backward(g)
    torch.cuda.synchronize()
    assert (bn_fused.bn_forward.launches,
            bn_fused.bn_backward.launches) == launches
    assert out.dtype == dtype
    for got, w in ((out, want), (h.grad, hp.grad), (bn.scale.grad, sp.grad),
                   (bn.bias.grad, bp.grad), (bn.mean, rm), (bn.std, rs)):
        assert torch.equal(got.detach(), w.detach())


# GNNLineGraph's smallest and largest shape groups in the benchmark's
# lggnn_L5_h1.train_b2048 cell: 2,048 molecules a batch at node/edge
# buckets 16/32 and 32/64 (its 32/32 group takes the looped kernels too)
LG_GROUPS = {"n16_m32": (16, 32), "n32_m64": (32, 64)}
LG_BATCH = 2048
REGISTER_ROWS = 32768  # bn_fused.cu:fits_registers at F = 2 (VEC 2 or 1)
_BN_KERNEL = re.compile(r"bn_(forward|backward)<\d,\s*(true|false)>")


def _lg_model(cuda):
    from hgnn2_torch.nn import models

    return models.GNNLineGraph(in_features=5, n_features=1, n_layers=5, J=1,
                               order=2,
                               generator=torch.Generator().manual_seed(3)).to(cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("group", list(LG_GROUPS))
def test_lggnn_step_at_the_cells_shapes(cuda, group, monkeypatch):
    """One GNNLineGraph (L 5, h 1, order 2) train step at the cell's
    smallest and largest shape groups: each of its 8 MaskedBatchNorm
    calls (a node and an edge norm a layer) launches bn_forward and
    bn_backward once; a call of R >
    32,768 rows takes the looped instantiation (``<VEC, false>`` in the
    kernel's name), a smaller one the cached; each call's output and
    running buffers match bn_fused.composed on its input, and the step's
    gradients match the same step with every norm composed. The cv2
    biases feed a train-mode norm, so their exact gradient is 0 and both
    sides give rounding: held to 1e-5 of the largest gradient."""
    from hgnn2_torch.data import batching, qm9

    recs = sorted(qm9.synthetic_qm9_like(8192, seed=0), key=lambda r: r.n_nodes)
    chunk = recs[:LG_BATCH] if group == "n16_m32" else recs[-LG_BATCH:]
    batch = next(iter(batching.DenseLoader(chunk, LG_BATCH, task=0,
                                           with_line_graph=True, device=cuda)))
    n_b, m_b = batch.x.shape[1], batch.lg_src.shape[1]
    assert (n_b, m_b) == LG_GROUPS[group]
    g = torch.randn(LG_BATCH, 1, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5))

    def step(model):
        model.zero_grad()
        model(batch).backward(g)
        torch.cuda.synchronize()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    model = _lg_model(cuda).train()
    calls = []

    def pre(mod, args):
        calls.append([mod, args[0].detach().clone(), args[1].detach().clone(),
                      mod.mean.clone(), mod.std.clone()])

    def post(mod, args, out):
        calls[-1].append(out.detach().clone())

    norms = [m for m in model.modules() if isinstance(m, layers.MaskedBatchNorm)]
    hooks = [h for m in norms for h in (m.register_forward_pre_hook(pre),
                                        m.register_forward_hook(post))]
    launches = bn_fused.bn_forward.launches, bn_fused.bn_backward.launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads = step(model)
    for h in hooks:
        h.remove()
    assert len(norms) == len(calls) == 8
    assert (bn_fused.bn_forward.launches - launches[0],
            bn_fused.bn_backward.launches - launches[1]) == (8, 8)
    rows = [c[1].numel() // c[1].shape[-1] for c in calls]
    assert sorted(rows) == sorted([LG_BATCH * n_b] * 4 + [LG_BATCH * m_b] * 4)
    want = {}
    for r in rows:
        looped = "false" if r > REGISTER_ROWS else "true"
        for d in ("forward", "backward"):
            want[(d, looped)] = want.get((d, looped), 0) + 1
    seen = {}
    for e in prof.key_averages():
        k = _BN_KERNEL.search(e.key)
        if k:
            seen[k.groups()] = seen.get(k.groups(), 0) + e.count
    assert seen == want, (seen, want)
    for mod, h, m, rm, rs, out in calls:
        rm_c, rs_c = rm.clone(), rs.clone()
        ref, _ = bn_fused.composed(h, m, mod.scale, mod.bias, rm_c, rs_c,
                                   mod.momentum, mod.eps, mod.compat.mask_bn_output)
        _close("out", out, ref, FWD_RTOL)

    composed = _lg_model(cuda).train()
    monkeypatch.setattr(bn_fused, "use_kernel", lambda *a: False)
    want_grads = step(composed)
    for (name, a), b in zip(model.state_dict().items(),
                            composed.state_dict().values()):
        _close(name, a, b, FWD_RTOL)  # the running buffers after the step
    top = max(float(v.abs().max()) for v in want_grads.values())
    for name, got in grads.items():
        if name.endswith("_cv2.bias"):
            assert float(got.abs().max()) <= 1e-5 * top, name
            assert float(want_grads[name].abs().max()) <= 1e-5 * top, name
        else:
            _close(name, got, want_grads[name], GRAD_RTOL)
