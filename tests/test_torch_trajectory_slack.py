"""The rounding allowance of the trajectory tests
(tests/test_torch_gnn_train.py, test_torch_lggnn_train.py,
test_torch_packed_train.py, test_torch_scan.py), kept in one place, and
the float64 test that proves which entries it covers.

Which entries. An entry gets an allowance on a step only where its exact
gradient on that step is zero by the model's structure, so that what f32
leaves there is rounding alone (the two packages round in other orders):

  * a conv bias whose unit reaches the loss only through a train-mode
    MaskedBatchNorm as a shift: the cv2 of a line-graph layer (linear into
    BN), or a ReLU'd unit (cv1 everywhere, cv2 of a power layer) whose ReLU
    is on at every real position of the step's batch. BN subtracts the
    batch mean, so a shift of the whole column changes nothing. A gated
    update (gru) between the convs and BN breaks this: nothing is flagged
    there;
  * a weight of such a unit that reads an input column which is constant
    over the real positions (a dead feature's BN output, or Pm^T of one):
    it acts as a second bias;
  * every entry of a unit whose ReLU is off at every real position, and
    a weight of any unit that reads zeros wherever its ReLU is on (the
    non-backtracking operator gives 0 on an edge out of a leaf: the port
    computes that 0 exactly, JAX as a cancellation);
  * the readout weights of the line-graph models' Pd block: the readout
    sums over a graph's nodes, and the node sum of a signed incidence
    apply is zero.

The flags come from the port's f32 forward, where a zero or a constant is
taken as such only if it is exact. Entries whose exact gradient is zero in
other ways get f32 gradients of exactly 0.0 in the port;
test_flagged_entries_are_exactly_the_zero_gradients checks that too.

How much. Adamax (optax's and torch's, eps inside the max) moves an entry
on step t (from 1) by lr_t / (1 - b1^t) * m_t / u_t, with
m_t = (1 - b1) sum_{s<=t} b1^(t-s) g_s and u_t = max(b2 u_{t-1}, |g_t| + eps),
so u_t >= b2^(t-s) |g_s| for every s <= t. Hence
  |m_t| / u_t <= (1 - b1) sum_{k<t} (b1 / b2)^k,
and the largest move of one package on step t is
  B_t = lr_t (1 - b1) / (1 - b1^t) * sum_{k<t} (b1 / b2)^k <= lr_t / b2^(t-1),
whatever the gradients were. Rounding picks the sign of each package's move
on its own, so on a flagged step the two packages' values of the entry
part by at most 2 B_t more; over a trajectory the allowance is the sum of
2 B_t over the steps at which the entry was flagged, about
2 sum_t lr_t / b2^(t-1). A BN running mean gets its unit's bias's
allowance (the batch mean moves with the bias).

Adamax's eps band. One other case moves an entry by a step that rounding
decides: a real gradient within 100 eps of zero (1e-6, eps = 1e-8). There
the first move, lr g / (|g| + eps), follows g's relative error, and an
entry's relative error is large where g is small against the step's
largest gradient: a GRU's hh kernel entry at g = 2.5038e-8 (port) and
2.4871e-8 (JAX), 1e-12 of the largest, first moves 7.1459e-4 and
7.1323e-4. Above the band the move's sensitivity, lr eps / g^2 per unit
of g, is below 10 and rounding does not show. An unflagged entry whose
gradient lies in the band in both packages gets lr_t for that step, as
these tests always allowed. Every other entry keeps the tests' atol.

The flags are read from the port's own forward in train mode:
layers.pair_conv (and packed's copy) is wrapped to keep the convs' input,
and a pre-hook on each MaskedBatchNorm reads its input and mask."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from hgnn2_torch.data import batching, qm9
from hgnn2_torch import graphs
from hgnn2_torch.nn import layers, models, packed
from hgnn2_torch.training import train

B1, B2 = 0.9, 0.999  # training/optim.py: Adamax's betas
EPS_BAND = 100 * 1e-8  # gradients within 100 x Adamax's eps of zero
SEEDS = 5  # model draws of the float64 test


def adamax_bound(t: int, lr: float, b1: float = B1, b2: float = B2) -> float:
    """B_t: the largest move Adamax can make to one entry on step t (from
    1) at learning rate lr, whatever the gradients (module docstring)."""
    ratio = sum((b1 / b2) ** k for k in range(t))
    return float(lr) * (1.0 - b1) / (1.0 - b1 ** t) * ratio


def _readout_pd_block(model) -> dict[str, torch.Tensor]:
    """The line-graph readouts' Pd columns: [graph_op x | Pm xl | Pd xl]
    ends with Pd xl, of the edge state's width."""
    if isinstance(model, models.GNNLineGraph):
        fc, xlw = model.layerlast.fc, 2 * model.n_features
    elif isinstance(model, packed.PackedLGGNN):
        fc = model.fc
        xlw = 2 * model.n_features if model.n_layers > 1 else 1
    else:
        return {}
    flag = torch.zeros(fc.weight.shape, dtype=torch.bool)
    flag[:, -xlw:] = True
    return {fc.weight: flag}


class ZeroGradientFlags:
    """Inside the block, records one train-mode forward of ``model`` (a
    port GNNSimple, GNNLineGraph, PackedGNN or PackedLGGNN); ``flags()``
    then gives {parameter name: bool mask} of the entries whose exact
    gradient is zero by structure (module docstring)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.names = {p: n for n, p in model.named_parameters()}

    def __enter__(self):
        self._flags: dict[torch.nn.Parameter, torch.Tensor] = {}
        self._pending = None
        real_pair = layers.pair_conv

        def pair_conv(cv1, cv2, x1, relu_second, dtype=None):
            out = real_pair(cv1, cv2, x1, relu_second, dtype)
            self._pending = (cv1, cv2, x1.detach(), relu_second, out)
            return out

        self._stack = contextlib.ExitStack()
        for mod in (layers, packed):
            self._stack.enter_context(
                mock.patch.object(mod, "pair_conv", pair_conv))
        for m in self.model.modules():
            if isinstance(m, layers.MaskedBatchNorm):
                hook = m.register_forward_pre_hook(self._bn)
                self._stack.callback(hook.remove)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def _flag(self, p: torch.nn.Parameter, mask: torch.Tensor) -> None:
        old = self._flags.get(p, torch.zeros(p.shape, dtype=torch.bool))
        self._flags[p] = old | mask.cpu()

    def _bn(self, bn, args):
        h, mask = args[0], args[1]
        pending, self._pending = self._pending, None
        if not bn.training or pending is None:
            return
        cv1, cv2, x1, relu_second, out = pending
        if h.data_ptr() != out.data_ptr():
            return  # a gated update between the convs and BN
        real = mask.reshape(-1) > 0
        hr = h.detach().reshape(-1, h.shape[-1])[real]
        xr = x1.reshape(-1, x1.shape[-1])[real]
        const = (xr == xr[:1]).all(0)
        f = h.shape[-1] // 2  # BN's features: concat(cv2, cv1)
        for cv, cols, relu in ((cv2, slice(0, f), relu_second),
                               (cv1, slice(f, 2 * f), True)):
            # (positions, units): where the gradient reaches a unit
            on = (hr[:, cols] > 0 if relu
                  else torch.ones_like(hr[:, cols], dtype=torch.bool))
            shift = on.all(0)
            zero_where_on = ((xr[:, None, :] == 0) | ~on[:, :, None]).all(0)
            self._flag(cv.bias, shift | ~on.any(0))
            self._flag(cv.weight,
                       zero_where_on | (shift[:, None] & const[None, :]))

    def flags(self) -> dict[str, torch.Tensor]:
        out = {self.names[p]: f for p, f in self._flags.items()}
        for p, f in _readout_pd_block(self.model).items():
            out[self.names[p]] = f
        return out


class TrajectorySlack:
    """The allowance of each entry over a trajectory, in the flax layout.
    Wrap each port step in ``step(lr)`` (the block runs the step's
    forward, backward and update); ``allowance(jax_grads)``, given JAX's
    gradients of the same steps, then sums per entry 2 B_t over the steps
    at which it was flagged, and lr_t over the other steps at which its
    gradient lay in Adamax's eps band in both packages (module
    docstring). to_flax maps a port state dict to the flax variables
    ({"params": ...})."""

    def __init__(self, model: torch.nn.Module, to_flax):
        self.model, self.to_flax = model, to_flax
        self.steps: list[tuple[float, dict, dict]] = []  # lr, flags, grads

    def _flax(self, tensors: dict) -> dict[tuple, np.ndarray]:
        return dict(_leaves(self.to_flax(tensors)["params"]))

    @contextlib.contextmanager
    def step(self, lr: float):
        rec = ZeroGradientFlags(self.model)
        with rec:
            yield
        params = dict(self.model.named_parameters())
        flags = {n: torch.zeros(p.shape) for n, p in params.items()}
        flags.update({n: f.float() for n, f in rec.flags().items()})
        grads = {n: p.grad.detach().cpu().clone() for n, p in params.items()}
        self.steps.append((float(lr), self._flax(flags), self._flax(grads)))

    def allowance(self, jax_grads: list[dict]) -> dict[tuple, np.ndarray]:
        assert len(jax_grads) == len(self.steps)
        total: dict[tuple, np.ndarray] = {}
        for t, ((lr, flags, grads), jg) in enumerate(
                zip(self.steps, jax_grads), start=1):
            jg = dict(_leaves(jg))
            for path, f in flags.items():
                band = ((np.abs(grads[path]) < EPS_BAND)
                        & (np.abs(jg[path]) < EPS_BAND) & (f == 0))
                total[path] = (total.get(path, 0.0)
                               + 2.0 * adamax_bound(t, lr) * f + lr * band)
        return total


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_adamax_bound_holds_for_any_gradients():
    """torch's Adamax from 0 on random gradient sequences (signs and sizes
    from rounding level to 1) never moves an entry by more than B_t on a
    step, and B_t <= lr / b2^(t-1); the first step of a gradient of 1
    reaches it, up to eps."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        g = (rng.standard_normal((20, 64))
             * 10.0 ** rng.uniform(-9, 0, (20, 64)))
        if trial == 0:
            g = np.ones((20, 64))
        p = torch.zeros(64, dtype=torch.float64, requires_grad=True)
        opt = torch.optim.Adamax([p], lr=1e-3, betas=(B1, B2), eps=1e-8)
        for t in range(1, 21):
            before = p.detach().clone()
            p.grad = torch.from_numpy(g[t - 1])
            opt.step()
            move = (p.detach() - before).abs().max().item()
            bound = adamax_bound(t, 1e-3)
            assert move <= bound * (1 + 1e-12), (trial, t)
            assert bound <= 1e-3 / B2 ** (t - 1) * (1 + 1e-12)
            if trial == 0 and t == 1:
                np.testing.assert_allclose(move, bound, rtol=1e-7)


def _double(batch):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
        and getattr(batch, f.name).is_floating_point()})


def _grads(model, batch, mean, std):
    """One train-mode step's gradients and the flags of its forward, in
    the model's dtype (a float64 model takes a float64 batch)."""
    if next(model.parameters()).dtype == torch.float64:
        batch = _double(batch)
    model.train()
    model.zero_grad()
    with ZeroGradientFlags(model) as rec:
        out = model(batch)
    loss, _ = train._loss_and_metrics(out, batch.y, train._graph_mask(batch),
                                      "regression", mean, std)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return grads, rec.flags()


CASES = {
    "gnn": lambda c: models.GNNSimple(in_features=5, n_features=2, n_layers=4,
                                      J=1, compat=c),
    "gnn_gru": lambda c: models.GNNSimple(in_features=5, n_features=2,
                                          n_layers=4, J=2, gru=True, compat=c),
    "lggnn": lambda c: models.GNNLineGraph(in_features=5, n_features=2,
                                           n_layers=4, J=1, order=2, compat=c),
    "lggnn_order3": lambda c: models.GNNLineGraph(
        in_features=5, n_features=2, n_layers=4, J=2, order=3, compat=c),
    "packed_gnn": lambda c: packed.PackedGNN(in_features=5, n_features=2,
                                             n_layers=4, J=2, compat=c),
    "packed_lggnn": lambda c: packed.PackedLGGNN(
        in_features=5, n_features=2, n_layers=3, order=2, compat=c),
}


@pytest.mark.parametrize("compat", [False, True], ids=["plain", "reference"])
@pytest.mark.parametrize("arch", list(CASES))
def test_flagged_entries_are_exactly_the_zero_gradients(arch, compat):
    """In float64 (model.double(); BN and the readout sum then keep
    float64), on the trajectory tests' molecules and shapes, every flagged
    entry's gradient is at most 1e-12 x the largest, and every unflagged
    entry's is larger, or else (a dead feature's BN scale, say) is
    exactly 0.0 in the model's float32 step as well, which needs no
    allowance. The flags hold across model draws;
    a line-graph cv2 bias is flagged always, a ReLU'd bias of the power
    models in some draw (plain flags)."""
    recs = qm9.synthetic_qm9_like(40, seed=2)
    ys = np.array([r.y[0] for r in recs])
    mean, std = float(ys.mean()), float(ys.std())
    if arch.startswith("packed"):
        batch = next(iter(batching.PackedLoader(recs, 24, device="cpu",
                                                task=0)))
    else:
        batch = graphs.make_dense_batch(
            recs[:20], device="cpu", n_max=32, batch_size=24, task=0,
            **(dict(m_max=64, with_line_graph=True) if "lggnn" in arch else {}))
    cfg = layers.CompatConfig.reference() if compat else layers.CompatConfig()
    n_flagged = {}
    for seed in range(SEEDS):
        torch.manual_seed(seed)
        model = CASES[arch](cfg)
        g32, _ = _grads(copy.deepcopy(model), batch, mean, std)
        g64, flags = _grads(model.double(), batch, mean, std)
        top = max(g.abs().max().item() for g in g64.values())
        for name, g in g64.items():
            flag = flags.get(name, torch.zeros(g.shape, dtype=torch.bool))
            zero = g.abs() <= 1e-12 * top
            assert bool(zero[flag].all()), (name, g[flag & ~zero])
            exact = g32[name] == 0.0
            assert bool((exact | ~zero)[~flag].all()), (
                name, g32[name][zero & ~flag])
            n_flagged[name] = n_flagged.get(name, 0) + int(flag.sum())
    biases = {n: k for n, k in n_flagged.items() if n.endswith("bias")
              and ("cv1" in n or "cv2" in n)}
    if arch == "gnn_gru":
        assert sum(biases.values()) == 0
    elif "lggnn" in arch:
        assert all(k == SEEDS * 2 for n, k in biases.items() if "cv2" in n)
    elif not compat:  # no uniform ReLU in these PackedGNN draws under compat
        assert sum(biases.values()) > 0, n_flagged
