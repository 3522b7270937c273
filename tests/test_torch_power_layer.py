"""GNNSimple's power layer as one kernel each way (hgnn2_torch/ops/
power_layer.py, csrc/power_layer.cu) and the rule that picks them.

On the CPU: the plain backward formulas (power_layer.backward_reference)
against autograd through the composition (power_layer.composed) in
float64, to 1e-10, at N 16 and 32, input widths 5 and 2, J 1 and 2, with
padded rows and both compat configurations (and each flag alone);
``composed`` bit for bit against PowerLayer's own path; the plain versions
(the wrappers on CPU tensors) against hgnn2_tpu's PowerLayer through
hgnn2_torch.convert (forward, gradients, running statistics); the autograd
Function by gradcheck; PowerLayer routed through the wrappers against its
composition; the dispatch rule and the refusals.

On the card (marked requires_cuda; each skips without a card): the kernels
against the composition at the GNN cell's shapes (1,024 graphs of 16 and
32 node slots, input widths 5 and 2, so fan-ins 15 and 6; h 1) and at h 2,
J 2 and the reference compat: outputs, statistics, running buffers and
every gradient, one launch each way (the wrappers' counts), the same
bits on a second run; a
captured and replayed GNNSimple step against the same step composed; BN
recalibration's no-grad train forwards; the calls the rule sends to the
composition launch nothing. The file imports the port only (the JAX
comparison imports JAX inside its test), so the card half runs where JAX
is not installed:

    python -m pytest --noconftest tests/test_torch_power_layer.py -q

Tolerances on the card: the kernels sum in another order than cuBLAS and
the composition's reductions, in float32; every elementwise step of the
batch norm rounds alike, so from the kernel's own statistics and z the
composition's batch-norm ops give the kernel's output bit for bit.
Forward values are held to FWD_RTOL, gradients to GRAD_RTOL, each times
the largest |value| of the tensor compared.
"""

import dataclasses

import pytest
import torch

from hgnn2_torch.nn import layers, models
from hgnn2_torch.nn.bundles import DenseBundle
from hgnn2_torch.ops import dense as D
from hgnn2_torch.ops import power_layer

COMPATS = {"default": layers.CompatConfig(),
           "reference": layers.CompatConfig.reference(),
           "scalar_affine": layers.CompatConfig(scalar_affine_bn=True),
           "unmasked_out": layers.CompatConfig(mask_bn_output=False)}
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-2  # a whole model's step: the least gradient scale, x its max


def _inputs(B, N, fi, J, features_out, compat, dtype=torch.float64,
            device="cpu", seed=0):
    """A layer's inputs: graphs of 1..N real nodes (a non-symmetric
    weighted adjacency among them, so A^T differs from A), x random on
    every slot (padded rows too), node mask, the convolutions' weights,
    the batch norm's scale and bias (0-d under scalar_affine_bn) and
    running buffers. Returns a dict of the power_forward arguments."""
    gen = torch.Generator().manual_seed(seed)
    n_real = torch.randint(1, N + 1, (B,), generator=gen)
    mask = (torch.arange(N)[None] < n_real[:, None]).double()
    adj = ((torch.rand(B, N, N, generator=gen) < 0.3).double()
           * torch.rand(B, N, N, generator=gen, dtype=torch.float64))
    adj = adj * mask[:, :, None] * mask[:, None, :]
    H, K = features_out, (J + 2) * fi
    h2 = 2 * H
    pshape = () if compat.scalar_affine_bn else (h2,)
    t = dict(
        x=torch.randn(B, N, fi, generator=gen, dtype=torch.float64),
        adj_powers=D.adjacency_powers(adj, J).contiguous(),
        deg=D.degrees(adj), node_mask=mask, mask=mask.clone(),
        w1=torch.randn(H, K, generator=gen, dtype=torch.float64) * 0.3,
        b1=torch.randn(H, generator=gen, dtype=torch.float64) * 0.1,
        w2=torch.randn(H, K, generator=gen, dtype=torch.float64) * 0.3,
        b2=torch.randn(H, generator=gen, dtype=torch.float64) * 0.1,
        scale=torch.randn(pshape, generator=gen, dtype=torch.float64),
        bias=torch.randn(pshape, generator=gen, dtype=torch.float64),
        run_mean=torch.randn(h2, generator=gen, dtype=torch.float64),
        run_std=torch.rand(h2, generator=gen, dtype=torch.float64) + 0.5)
    return {k: v.to(dtype=dtype, device=device) for k, v in t.items()}


ARGS = ("x", "adj_powers", "deg", "node_mask", "mask", "w1", "b1", "w2",
        "b2", "scale", "bias", "run_mean", "run_std")
GRAD_ARGS = ("x", "w1", "b1", "w2", "b2", "scale", "bias")


def _composed_grads(t, g, mask_out):
    """The composition's output, z, batch statistics and the gradients of
    <out, g> for GRAD_ARGS by autograd; the running buffers of ``t``
    are left as they were."""
    leaves = {k: t[k].detach().clone().requires_grad_() for k in GRAD_ARGS}
    args = [leaves.get(k, t[k]) for k in ARGS]
    args[11], args[12] = t["run_mean"].clone(), t["run_std"].clone()
    out, z, stats = power_layer.composed(*args, 0.1, 1e-5, mask_out)
    out.backward(g)
    return out.detach(), z.detach(), stats, [leaves[k].grad for k in GRAD_ARGS]


SHAPES = {"N16_fi5": (16, 5), "N32_fi2": (32, 2)}


@pytest.mark.parametrize("compat", list(COMPATS))
@pytest.mark.parametrize("J", [1, 2])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_formulas_match_autograd(shape, J, compat):
    cfg = COMPATS[compat]
    N, fi = SHAPES[shape]
    t = _inputs(6, N, fi, J, 1, cfg)
    g = torch.randn(6, N, 2, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    _, z, (mean, std, count), want = _composed_grads(t, g, cfg.mask_bn_output)
    stats = torch.cat([mean.detach(), std.detach(), count.reshape(1)])
    got = power_layer.backward_reference(
        g, t["x"], t["adj_powers"], t["deg"], t["node_mask"], t["mask"],
        t["w1"], t["w2"], t["scale"], z, stats, cfg.mask_bn_output)
    for name, a, b in zip(GRAD_ARGS, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)


def _layer_and_bundle(fi, features_out, J, compat, B=5, N=16, seed=1,
                      dtype=torch.float32):
    """A PowerLayer and a DenseBundle of random graphs (on the CPU)."""
    t = _inputs(B, N, fi, J, features_out, compat, dtype, seed=seed)
    layer = layers.PowerLayer((J + 2) * fi, features_out, compat,
                              generator=torch.Generator().manual_seed(seed)
                              ).to(dtype)
    adj = t["adj_powers"][:, 0].contiguous()
    bundle = DenseBundle(adj_powers=D.adjacency_powers(adj, J),
                         deg=D.degrees(adj), J=J, node_mask=t["node_mask"])
    return layer, bundle, t


@pytest.mark.parametrize("compat", ["default", "reference"])
@pytest.mark.parametrize("J", [1, 2])
def test_composed_is_power_layer_bit_for_bit(J, compat):
    """composed, given the layer's own tensors, is PowerLayer's path (its
    composition on the CPU): output, running buffers and gradients equal
    bit for bit."""
    cfg = COMPATS[compat]
    layer, bundle, t = _layer_and_bundle(5, 2, J, cfg)
    x = t["x"].requires_grad_()
    out = layer.train()(bundle, x, t["mask"])
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g)
    bn = layer.bn
    params = [p.detach().clone().requires_grad_() for p in (
        layer.cv1.weight, layer.cv1.bias, layer.cv2.weight, layer.cv2.bias,
        bn.scale, bn.bias)]
    xc = t["x"].detach().clone().requires_grad_()
    fresh = layers.PowerLayer((J + 2) * 5, 2, cfg,
                              generator=torch.Generator().manual_seed(1))
    rm, rs = fresh.bn.mean.clone(), fresh.bn.std.clone()
    want, _, _ = power_layer.composed(
        xc, bundle.adj_powers, bundle.deg, bundle.node_mask, t["mask"],
        *params, rm, rs, bn.momentum, bn.eps, cfg.mask_bn_output)
    want.backward(g)
    assert torch.equal(out.detach(), want.detach())
    assert torch.equal(bn.mean, rm) and torch.equal(bn.std, rs)
    assert torch.equal(x.grad, xc.grad)
    for p, q in zip((layer.cv1.weight, layer.cv1.bias, layer.cv2.weight,
                     layer.cv2.bias, bn.scale, bn.bias), params):
        assert torch.equal(p.grad, q.grad)


@pytest.mark.parametrize("fi, features_out, J, compat", [
    (5, 1, 1, "default"), (2, 1, 2, "reference"), (4, 2, 1, "default")])
def test_plain_versions_match_jax(fi, features_out, J, compat):
    """power_forward and power_backward on CPU tensors (their plain
    versions) against hgnn2_tpu's PowerLayer from the same flax weights
    (hgnn2_torch.convert): the train-mode output, the running statistics
    it leaves, and the gradients of <out, g> for x and every parameter."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax", reason="hgnn2_tpu's models need flax")
    import jax.numpy as jnp
    import numpy as np

    from hgnn2_torch import convert
    from hgnn2_tpu.nn import bundles as jbundles
    from hgnn2_tpu.nn import layers as jlayers

    cfg = COMPATS[compat]
    jcfg = (jlayers.CompatConfig.reference() if compat == "reference"
            else jlayers.CompatConfig())
    t = _inputs(7, 16, fi, J, features_out, cfg, torch.float32, seed=3)
    adj = t["adj_powers"][:, 0].numpy()

    class Batch:  # what jbundles.DenseBundle.from_batch reads
        pass

    jb = Batch()
    jb.adj, jb.node_mask, jb.has_line_graph = (jnp.asarray(adj),
                                               jnp.asarray(t["mask"].numpy()),
                                               False)
    jbundle = jbundles.DenseBundle.from_batch(jb, J)
    jlayer = jlayers.PowerLayer(features_out, compat=jcfg)
    x, mask = jnp.asarray(t["x"].numpy()), jnp.asarray(t["mask"].numpy())
    variables = jax.tree.map(np.asarray, jlayer.init(
        jax.random.key(0), jbundle, x, mask, train=True))
    want, upd = jlayer.apply(variables, jbundle, x, mask, train=True,
                             mutable=["batch_stats"])
    g = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)

    def loss(params, x):
        out, _ = jlayer.apply(dict(variables, params=params), jbundle, x, mask,
                              train=True, mutable=["batch_stats"])
        return (out * g).sum()

    jg_params, jg_x = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    state = convert.variables_from_flax(variables)
    layer = layers.PowerLayer((J + 2) * fi, features_out, cfg)
    layer.load_state_dict(state)
    adj_t = torch.from_numpy(adj)
    bundle = DenseBundle(adj_powers=D.adjacency_powers(adj_t, J),
                         deg=D.degrees(adj_t), J=J, node_mask=t["mask"])
    bn = layer.bn
    w = (layer.cv1.weight.detach(), layer.cv1.bias.detach(),
         layer.cv2.weight.detach(), layer.cv2.bias.detach(),
         bn.scale.detach(), bn.bias.detach())
    out, z, stats = power_layer.power_forward(
        t["x"], bundle.adj_powers, bundle.deg, bundle.node_mask, t["mask"], *w,
        bn.mean, bn.std, bn.momentum, bn.eps, cfg.mask_bn_output)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **tol)
    jstats = jax.tree.map(np.asarray, upd["batch_stats"])["bn"]
    np.testing.assert_allclose(bn.mean.numpy(), jstats["mean"], **tol)
    np.testing.assert_allclose(bn.std.numpy(), jstats["std"], **tol)
    dx, gw1, gb1, gw2, gb2, gs, gb = power_layer.power_backward(
        torch.from_numpy(g), t["x"], bundle.adj_powers, bundle.deg,
        bundle.node_mask, t["mask"], w[0], w[2], w[4], z, stats,
        cfg.mask_bn_output)
    jp = jax.tree.map(np.asarray, jg_params)
    for name, got, ref in (
            ("x", dx, jg_x), ("cv1.kernel", gw1.T, jp["cv1"]["kernel"]),
            ("cv1.bias", gb1, jp["cv1"]["bias"]),
            ("cv2.kernel", gw2.T, jp["cv2"]["kernel"]),
            ("cv2.bias", gb2, jp["cv2"]["bias"]),
            ("bn.scale", gs, jp["bn"]["scale"]),
            ("bn.bias", gb, jp["bn"]["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("compat", ["default", "reference"])
def test_function_gradcheck_on_cpu(compat):
    """The autograd Function, whose wrappers run the plain versions on the
    CPU: its backward against finite differences of its forward."""
    cfg = COMPATS[compat]
    t = _inputs(3, 8, 2, 1, 1, cfg, seed=5)
    leaves = [t[k].requires_grad_() for k in GRAD_ARGS]

    def fn(x, w1, b1, w2, b2, scale, bias):
        return power_layer.power_layer(
            x, t["adj_powers"], t["deg"], t["node_mask"], t["mask"], w1, b1,
            w2, b2, scale, bias, t["run_mean"].clone(), t["run_std"].clone(),
            0.1, 1e-5, cfg.mask_bn_output)

    assert torch.autograd.gradcheck(fn, tuple(leaves))


@pytest.mark.parametrize("compat", ["default", "reference"])
@pytest.mark.parametrize("J", [1, 2])
def test_module_kernel_path_matches_composition_on_cpu(monkeypatch, J,
                                                       compat):
    """PowerLayer with the rule forced to the kernel path (whose wrappers
    run the plain versions on the CPU) against its composition, in
    float64: output, running buffers and every gradient equal to 1e-10."""
    cfg = COMPATS[compat]
    runs = []
    for forced in (False, True):
        monkeypatch.setattr(power_layer, "use_kernel",
                            lambda *a, forced=forced: forced)
        layer, bundle, t = _layer_and_bundle(5, 1, J, cfg,
                                             dtype=torch.float64)
        x = t["x"].requires_grad_()
        launches = power_layer.power_forward.launches
        out = layer.train()(bundle, x, t["mask"])
        out.pow(2).sum().backward()
        assert power_layer.power_forward.launches == launches  # the CPU
        runs.append([out.detach(), layer.bn.mean.clone(), layer.bn.std.clone(),
                     x.grad, *(p.grad for p in layer.parameters())])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


class _Like:
    """A stand-in for a tensor's device, dtype and shape: the rule reads
    nothing else, and a machine without a card has no CUDA tensor."""

    def __init__(self, shape, device="cuda", dtype=torch.float32,
                 requires_grad=False):
        self.shape, self.device = tuple(shape), torch.device(device)
        self.dtype, self.requires_grad = dtype, requires_grad

    def dim(self):
        return len(self.shape)


RULE_BASE = dict(B=1024, N=32, fi=5, J=1, features_out=1, training=True,
                 dtype=None, axis_name=None, gru=False, device="cuda",
                 x_dtype=torch.float32, adj=True, adj_grad=False)


@pytest.mark.parametrize("case, change, want", [
    ("cell N32", {}, True),
    ("cell N16 fi2", dict(N=16, fi=2), True),
    ("h2 J2", dict(fi=4, J=2, features_out=2), True),
    ("phase 6's 2,048 at N32", dict(B=2048), True),
    ("eval", dict(training=False), False),
    ("bf16 compute", dict(dtype=torch.bfloat16), False),
    ("float64", dict(x_dtype=torch.float64), False),
    ("bn_axis", dict(axis_name="data"), False),
    ("gru", dict(gru=True), False),
    ("cpu", dict(device="cpu"), False),
    ("no dense bundle", dict(adj=False), False),
    ("adjacency needs grad", dict(adj_grad=True), False),
    ("N64", dict(N=64), False),
    ("N odd", dict(N=30), False),
    ("fi3", dict(fi=3), False),
    ("J3", dict(J=3), False),
    ("h3", dict(features_out=3), False),
    ("rows over a cluster's registers", dict(B=2049), False),
    ("N16 at the cap", dict(B=4096, N=16, fi=2), True),
])
def test_dispatch_rule(case, change, want):
    r = dict(RULE_BASE, **change)
    x = _Like((r["B"], r["N"], r["fi"]), r["device"], r["x_dtype"])
    adj = (_Like((r["B"], r["J"], r["N"], r["N"]), r["device"],
                 requires_grad=r["adj_grad"]) if r["adj"] else None)
    assert power_layer.use_kernel(x, adj, r["features_out"], r["training"],
                                  r["dtype"], r["axis_name"], r["gru"]) is want


def test_module_takes_the_composition_off_the_kernel_path(monkeypatch):
    """On the CPU, in float64, in eval mode, with the GRU and with pooled
    statistics PowerLayer never calls the kernels' wrappers."""
    def refuse(*a, **k):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(power_layer, "power_forward", refuse)
    monkeypatch.setattr(power_layer, "power_backward", refuse)
    _, bundle, t = _layer_and_bundle(5, 1, 1, COMPATS["default"])
    for kw in ({}, {"gru": True}):
        layer = layers.PowerLayer(15, 1, **kw)
        for dtype in (torch.float32, torch.float64):
            lay = layer.to(dtype)
            b = DenseBundle(adj_powers=bundle.adj_powers.to(dtype),
                            deg=bundle.deg.to(dtype), J=1,
                            node_mask=bundle.node_mask.to(dtype))
            x = t["x"].to(dtype).requires_grad_()
            lay.train()(b, x, t["mask"].to(dtype)).sum().backward()
            lay.eval()(b, x, t["mask"].to(dtype))


@pytest.mark.parametrize("bad, msg", [
    ("adj", "adj_powers must be"), ("w1", "w1 must be"),
    ("scale", "scale must be"), ("dtype", "is torch.float32"),
    ("stats", "stats must be")])
def test_wrappers_refuse_bad_inputs(bad, msg):
    t = _inputs(3, 8, 2, 1, 1, COMPATS["default"])
    if bad == "adj":
        t["adj_powers"] = t["adj_powers"][:2]
    elif bad == "w1":
        t["w1"] = t["w1"][:, :5]
    elif bad == "scale":
        t["scale"] = t["scale"][:1]
    elif bad == "dtype":
        t["b1"] = t["b1"].float()
    if bad == "stats":
        with pytest.raises(ValueError, match=msg):
            power_layer.power_backward(
                torch.zeros(3, 8, 2, dtype=torch.float64), t["x"],
                t["adj_powers"], t["deg"], t["node_mask"], t["mask"], t["w1"],
                t["w2"], t["scale"], torch.zeros(3, 8, 2, dtype=torch.float64),
                torch.zeros(3, dtype=torch.float64), True)
        return
    with pytest.raises((ValueError, TypeError), match=msg):
        power_layer.power_forward(*(t[k] for k in ARGS), 0.1, 1e-5, True)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _close(name, got, want, rtol):
    got, want = got.detach(), want.detach()
    err = (float((got.double() - want.double()).abs().max())
           if got.numel() else 0.0)
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert torch.isfinite(got).all(), name
    assert err <= rtol * max(scale, 1e-30), (
        f"{name}: max err {err:.3e} over {rtol} x max |value| {scale:.3e}")


# the GNN cell's layer shapes: 1,024 graphs, node buckets 16 and 32, layer
# 0's input width 5 (fan-in 15) and the others' 2 (fan-in 6), h 1; then h 2,
# J 2 and a batch whose graphs do not fill the last chunk
CARD_CASES = {"cell_N16_fi5": (1024, 16, 5, 1, 1),
              "cell_N32_fi5": (1024, 32, 5, 1, 1),
              "cell_N16_fi2": (1024, 16, 2, 1, 1),
              "cell_N32_fi2": (1024, 32, 2, 1, 1),
              "h2_J2_N32_fi4": (1000, 32, 4, 2, 2),
              "ragged_N16_fi2": (37, 16, 2, 1, 1)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("compat", ["default", "reference"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_match_composition_on_the_card(cuda, case, compat):
    cfg = COMPATS[compat]
    B, N, fi, J, H = CARD_CASES[case]
    t = _inputs(B, N, fi, J, H, cfg, torch.float32, cuda)
    g = torch.randn(B, N, 2 * H, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    want, z_want, (mean, std, count), grads = _composed_grads(
        t, g, cfg.mask_bn_output)
    rm_c, rs_c = t["run_mean"].clone(), t["run_std"].clone()
    power_layer.composed(*(t[k] for k in ARGS[:11]), rm_c, rs_c, 0.1, 1e-5,
                         cfg.mask_bn_output)

    def run():
        leaves = {k: t[k].clone().requires_grad_() for k in GRAD_ARGS}
        args = [leaves.get(k, t[k]) for k in ARGS]
        args[11], args[12] = t["run_mean"].clone(), t["run_std"].clone()
        out = power_layer.power_layer(*args, 0.1, 1e-5, cfg.mask_bn_output)
        out.backward(g)
        torch.cuda.synchronize()
        return [out.detach(), args[11], args[12],
                *(leaves[k].grad for k in GRAD_ARGS)]

    launches = power_layer.power_forward.launches, power_layer.power_backward.launches
    first = run()
    assert (power_layer.power_forward.launches - launches[0],
            power_layer.power_backward.launches - launches[1]) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, run()))  # same bits

    out, rm_k, rs_k, *got = first
    _close("out", out, want, FWD_RTOL)
    _close("running mean", rm_k, rm_c, FWD_RTOL)
    _close("running std", rs_k, rs_c, FWD_RTOL)
    _, z, stats = power_layer.power_forward(
        *(t[k] for k in ARGS[:11]), t["run_mean"].clone(), t["run_std"].clone(),
        0.1, 1e-5, cfg.mask_bn_output)
    h2 = 2 * H
    _close("z", z, z_want, FWD_RTOL)
    _close("mean", stats[:h2], mean, FWD_RTOL)
    _close("std", stats[h2:2 * h2], std, FWD_RTOL)
    _close("count", stats[2 * h2:], count.reshape(1), FWD_RTOL)
    for name, a, w in zip(GRAD_ARGS, got, grads):
        assert a.shape == w.shape, name
        _close(name, a, w, GRAD_RTOL)
    # from the kernel's statistics and z the batch norm's ops give its bits
    mc = t["mask"][..., None]
    exact = t["scale"] * ((z * mc - stats[:h2]) / stats[h2:2 * h2]) + t["bias"]
    if cfg.mask_bn_output:
        exact = exact * mc
    assert torch.equal(out, exact)


def _gnn(cuda, seed=0, **kw):
    return models.GNNSimple(in_features=5, n_features=1, n_layers=15, J=1,
                            generator=torch.Generator().manual_seed(seed),
                            **kw).to(cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_bucket", [16, 32])
def test_captured_gnn_step_matches_composition(cuda, n_bucket, monkeypatch):
    """One GNNSimple (L 15, h 1, J 1) train step at the GNN cell's batch,
    1,024 molecules at node bucket 16 or 32, captured in a CUDA graph and
    replayed: each of its 14 PowerLayers launches one forward and one
    backward kernel (at capture), the replay gives the eager kernels' bits,
    and its output, running buffers and gradients match the same step with
    every layer composed in float64, to 1e-4 of each tensor's largest
    |value|, a gradient's largest taken at least GRAD_FLOOR x the model's
    largest gradient (chip_smoke.py's hold of this model, card against
    CPU: with a train-mode norm after each layer, a small gradient is a
    difference of much larger per-node terms, and its float32 error scales
    with them). The float32 composition is held the same way, as the
    yardstick that the bar fits float32."""
    from hgnn2_torch.data import batching, qm9

    recs = sorted(qm9.synthetic_qm9_like(4096, seed=0), key=lambda r: r.n_nodes)
    chunk = recs[:1024] if n_bucket == 16 else recs[-1024:]
    batch = next(iter(batching.DenseLoader(chunk, 1024, task=0, device=cuda)))
    assert batch.x.shape[1] == n_bucket
    g = torch.randn(1024, 1, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5))

    def body(model, b=batch):
        for p in model.parameters():
            p.grad = None
        out = model(b)
        out.backward(g.to(out.dtype))
        return out

    def state(model, out):
        return {"out": out.detach().clone(),
                **{k: v.clone() for k, v in model.state_dict().items()},
                **{f"{n}.grad": p.grad.clone()
                   for n, p in model.named_parameters()}}

    model = _gnn(cuda).train()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(model)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = power_layer.power_forward.launches, power_layer.power_backward.launches
    with torch.cuda.graph(graph):
        out_g = body(model)
    assert (power_layer.power_forward.launches - launches[0],
            power_layer.power_backward.launches - launches[1]) == (14, 14)
    model.load_state_dict(start)
    graph.replay()
    torch.cuda.synchronize()
    replayed = state(model, out_g)
    model.load_state_dict(start)
    eager = state(model, body(model))
    torch.cuda.synchronize()
    for k, v in replayed.items():
        assert torch.equal(v, eager[k]), k

    monkeypatch.setattr(power_layer, "use_kernel", lambda *a: False)
    composed = _gnn(cuda).train()
    want32 = state(composed, body(composed))
    batch64 = dataclasses.replace(batch, x=batch.x.double(),
                                  adj=batch.adj.double(),
                                  node_mask=batch.node_mask.double())
    exact = _gnn(cuda).double().train()
    want = state(exact, body(exact, batch64))
    torch.cuda.synchronize()
    top = max(float(v.abs().max()) for k, v in want.items() if k.endswith(".grad"))
    for k, w in want.items():
        scale = float(w.abs().max())
        if k.endswith(".grad"):
            scale = max(scale, GRAD_FLOOR * top)
        for side, got in (("kernels", replayed[k]), ("composition", want32[k])):
            assert torch.isfinite(got).all(), (side, k)
            err = float((got.double() - w).abs().max()) / scale
            assert err <= GRAD_RTOL, (
                f"{side} {k}: {err:.3e} of max(|value|, {GRAD_FLOOR} x the "
                f"largest gradient {top:.3e}) from float64")


@pytest.mark.requires_cuda
def test_recalibration_through_the_kernel(cuda, monkeypatch):
    """make_bn_recalibration's no-grad train forwards, captured, through
    the power-layer kernels (one forward a layer a Python-level forward, no
    backward) against the same with the rule forced to the composition."""
    from hgnn2_torch.data import batching, qm9
    from hgnn2_torch.training import train

    recs = qm9.synthetic_qm9_like(96, seed=5)
    batches = list(batching.DenseLoader(recs, 16, task=0, device=cuda))
    groups = train.group_stacked_batches(batches)
    results = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(power_layer, "use_kernel", lambda *a: False)
        model = models.GNNSimple(in_features=5, n_features=2, n_layers=3,
                                 generator=torch.Generator().manual_seed(0)).to(cuda)
        launches = power_layer.power_forward.launches, power_layer.power_backward.launches
        train.recalibrate_bn(model, groups=groups)
        assert (power_layer.power_forward.launches > launches[0]) is kernel
        assert power_layer.power_backward.launches == launches[1]
        results.append({k: v.clone() for k, v in model.state_dict().items()})
    for k, v in results[1].items():
        _close(k, results[0][k], v, FWD_RTOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["eval", "float64", "gru", "bn_axis", "N64",
                                  "bf16"])
def test_calls_off_the_rule_launch_nothing(cuda, case):
    """On the card, GNNSimple in eval mode, in float64, with the GRU, with
    pooled statistics, at node bucket 64 and in bf16 launches neither
    power-layer kernel, and its output is the composition's."""
    from hgnn2_torch.data import batching, qm9

    kw = {"gru": {"gru": True}, "bn_axis": {"bn_axis": "edge"},
          "bf16": {"dtype": torch.bfloat16}}.get(case, {})
    recs = qm9.synthetic_qm9_like(64, seed=2)
    bucket = (64,) if case == "N64" else (16, 32)
    batch = next(iter(batching.DenseLoader(recs, 64, task=0, device=cuda,
                                           node_buckets=bucket)))
    model = _gnn(cuda, **kw).train(case != "eval")
    if case == "float64":
        model = model.double()
        batch = dataclasses.replace(batch, x=batch.x.double(),
                                    adj=batch.adj.double(),
                                    node_mask=batch.node_mask.double())
    launches = power_layer.power_forward.launches, power_layer.power_backward.launches
    out = model(batch)
    if case != "eval":
        out.sum().backward()
    torch.cuda.synchronize()
    assert (power_layer.power_forward.launches,
            power_layer.power_backward.launches) == launches
    assert torch.isfinite(out).all()
