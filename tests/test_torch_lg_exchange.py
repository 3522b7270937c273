"""The line-graph exchange in index form (hgnn2_torch/ops/lg_exchange.py,
csrc/lg_exchange.cu), DenseBundle's one exchange, and the rule that picks
kernel or plain version.

On the CPU, in float64: the plain versions against ops/dense.py's one-hot
composition (outputs, and gradients by autograd through it) at the
benchmark's two shape groups (node/edge buckets 16/32 and 32/64, padded
edges with rev = 0 included), F = 1, 2 and 5; DenseBundle (whose wrappers
run the plain versions on the CPU) against MaterializedBundle at J = 1, 2
and 3, and GNNLineGraph (orders 1-3, J = 1 and 2) and a layer's whole
outputs, padded rows included, against the model run through the
composition; gradcheck of each autograd Function; the dispatch rule; the
paths off the kernel (the CPU in float32, float64, bf16), which move no
launch counter and give the composition's output and gradients, and
bf16's single rounding; the shared-memory plan and the wrappers'
refusals.

On the card (marked requires_cuda; each skips without a card): each kernel
and its backward against the plain version on the CPU (bit for bit: the
same products and sums in the same order, each rounded on its own) and
against the composition on the card, at the line-graph cell's two shape
groups (2,048 molecules) and at a graph too large to stage (the looped
instantiation); the plain versions on the card in float64 and bf16
against the CPU, no launch counted; a captured and replayed
GNNLineGraph step against the eager one, with the kernels' launches per
step from the counters and from the profiler. The file imports the port only, so it runs where JAX
is not installed:

    python -m pytest --noconftest tests/test_torch_lg_exchange.py -q

Tolerances: float64 sums in another order, 1e-12 of the largest |value|;
float32 (the composition's GEMVs on the card, its einsums on the CPU)
sums in another order, 1e-6 of the largest |value| (the segment sums add
at most a few terms); bf16, where the composition rounds after each
product and the index form once a wrapper, 2^-7 of the largest |value|
(bf16's rounding of its inputs and output, chip_smoke.py's bar for the
bf16 lg_graph_op).
"""

import re

import numpy as np
import pytest
import torch

from hgnn2_torch import graphs, operators
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import bundles, layers, models
from hgnn2_torch.ops import dense as D
from hgnn2_torch.ops import lg_exchange as X

GROUPS = {"n16_m32": (16, 32), "n32_m64": (32, 64)}
F64_RTOL = 1e-12
CARD_RTOL = 1e-6
BF16_RTOL = 2 ** -7
WRAPPERS = ("pm_pd_forward", "pm_pd_backward", "pm_pd_t_forward",
            "pm_pd_t_backward", "nb_forward", "nb_backward")


def _records(n_max: int, m_max: int, count: int, seed: int = 1):
    """count synthetic molecules that fit n_max node and m_max edge slots."""
    recs = [r for r in qm9.synthetic_qm9_like(8 * count, seed=seed)
            if r.n_nodes <= n_max and r.n_dir_edges <= m_max]
    return recs[:count]


def _batch(group: str, count: int = 10, dtype=torch.float64,
           scale_w: bool = True):
    """A dense line-graph batch of the group's shape on the CPU, its float
    arrays in dtype; scale_w scales the edge weights off their bond
    orders, so that sums round."""
    N, M = GROUPS[group]
    db = graphs.make_dense_batch(_records(N, M, count), n_max=N, m_max=M,
                                 with_line_graph=True, task=0, device="cpu")
    fields = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
              else v for k, v in db.__dict__.items()}
    if scale_w:
        gen = torch.Generator().manual_seed(7)
        scale = 1 + 0.3 * torch.rand(db.lg_w.shape, generator=gen,
                                     dtype=torch.float64)
        fields["lg_w"] = (db.lg_w.double() * scale).to(dtype)
    return type(db)(**fields)


def _close(got, want, rtol, msg=""):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    assert got.shape == want.shape, msg
    assert torch.isfinite(got).all(), msg
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= rtol * max(scale, 1e-30), f"{msg}: {err:.3e} over {scale:.3e}"


def _arrays(db):
    return db.lg_src, db.lg_dst, db.lg_rev, db.edge_mask, db.lg_w


def _composition(db):
    """The one-hot composition's operators of the batch (ops/dense.py)."""
    src, dst, rev, em, w = _arrays(db)
    s_src, s_dst = D.edge_scatter_matrices(src, dst, em, db.x.shape[1])
    s_src, s_dst = s_src.to(w.dtype), s_dst.to(w.dtype)
    dl = D.nb_degrees(s_src, s_dst, w, rev.long()) * em
    return {
        "pm_pd": lambda xl: torch.cat([D.incidence_apply(s_src, s_dst, xl, False),
                                       D.incidence_apply(s_src, s_dst, xl, True)], -1),
        "pm_pd_t": lambda x: torch.cat([D.incidence_t_apply(s_src, s_dst, x, False),
                                        D.incidence_t_apply(s_src, s_dst, x, True)], -1),
        "nb": lambda xl: D.nb_apply(s_src, s_dst, w, rev.long(), xl),
        "nb_full": lambda xl: D.lg_graph_op(s_src, s_dst, w, rev.long(), dl, xl,
                                            1, em),
        "dl": dl,
    }


class _CompositionBundle:
    """The line-graph exchange as ops/dense.py's one-hot composition over
    the batch's arrays, the rest of a DenseBundle as it is: the oracle of
    the index form in the model. Its operators are cast to dtype (bf16
    compute) after they are built in the batch's dtype."""

    has_line_graph = True

    def __init__(self, db, J, dtype=None):
        self.dense = bundles.DenseBundle.from_batch(db, J, dtype=dtype)
        src, dst, rev, em, w = _arrays(db)
        s_src, s_dst = D.edge_scatter_matrices(src, dst, em, db.x.shape[1])
        self.J, self.rev, self.em = J, rev.long(), em
        dl = D.nb_degrees(s_src, s_dst, w, self.rev) * em
        self.s_src, self.s_dst, self.w, self.dl = (
            t.to(dtype or w.dtype) for t in (s_src, s_dst, w, dl))

    def graph_op(self, x):
        return self.dense.graph_op(x)

    def lg_graph_op(self, xl):
        return D.lg_graph_op(self.s_src, self.s_dst, self.w, self.rev,
                             self.dl, xl, self.J, self.em)

    def pm_pd(self, xl):
        return torch.cat([D.incidence_apply(self.s_src, self.s_dst, xl, s)
                          for s in (False, True)], -1)

    def pm_pd_t(self, x):
        return torch.cat([D.incidence_t_apply(self.s_src, self.s_dst, x, s)
                          for s in (False, True)], -1)

    def edge_features(self):
        return self.dl[:, :, None]


def _plain(db):
    """The index form's plain versions with their hand-written gradients."""
    src, dst, rev, em, w = _arrays(db)
    N = db.x.shape[1]
    dl = X.nb_degrees(src, dst, rev, em, w, N)
    return {
        "pm_pd": (lambda xl: X.pm_pd_reference(src, dst, em, xl, N),
                  lambda g: X.pm_pd_grad_reference(src, dst, em, g)),
        "pm_pd_t": (lambda x: X.pm_pd_t_reference(src, dst, em, x),
                    lambda g: X.pm_pd_t_grad_reference(src, dst, em, g, N)),
        "nb": (lambda xl: X.nb_reference(src, dst, rev, em, w, xl, N),
               lambda g: X.nb_grad_reference(src, dst, rev, em, w, g, N)),
        "nb_full": (lambda xl: X.nb_reference(src, dst, rev, em, w, xl, N, dl),
                    lambda g: X.nb_grad_reference(src, dst, rev, em, w, g, N, dl)),
        "dl": dl,
    }


def _input(op, db, F, gen):
    B, N = db.x.shape[:2]
    rows = N if op == "pm_pd_t" else db.lg_src.shape[1]
    return torch.randn(B, rows, F, generator=gen, dtype=torch.float64)


OPS = ("pm_pd", "pm_pd_t", "nb", "nb_full")


@pytest.mark.parametrize("F", [1, 2, 5])
@pytest.mark.parametrize("group", list(GROUPS))
def test_plain_versions_match_composition(group, F):
    """Each op and its gradient: the plain index form against the one-hot
    composition and autograd through it, on every row (padded edges read
    edge 0 through rev = 0), and the NB degrees."""
    db = _batch(group)
    assert (db.edge_mask == 0).any() and (db.lg_rev[db.edge_mask == 0] == 0).all()
    comp, plain = _composition(db), _plain(db)
    _close(plain["dl"], comp["dl"], F64_RTOL, "dl")
    gen = torch.Generator().manual_seed(F)
    for op in OPS:
        x = _input(op, db, F, gen).requires_grad_()
        want = comp[op](x)
        fwd, bwd = plain[op]
        _close(fwd(x.detach()), want, F64_RTOL, op)
        g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (want_g,) = torch.autograd.grad(want, x, g)
        _close(bwd(g), want_g, F64_RTOL, f"{op} gradient")


def _materialized(recs, N, M, J):
    """MaterializedBundle over the port's dense operator builders, padded
    to (N, M) with zeros, in float64."""
    B = len(recs)
    W = np.zeros((B, N, N, J + 2))
    WL = np.zeros((B, M, M, J + 2))
    Pm = np.zeros((B, N, M))
    Pd = np.zeros((B, N, M))
    for i, r in enumerate(recs):
        n, m = r.n_nodes, r.n_dir_edges
        W[i, :n, :n] = operators.operator_stack_dense(r.adj, J)
        WL[i, :m, :m], Pm[i, :n, :m], Pd[i, :n, :m] = (
            operators.line_graph_operator_stack_dense(r.adj, J))
    return bundles.MaterializedBundle(*map(torch.from_numpy, (W, WL, Pm, Pd)))


@pytest.mark.parametrize("J", [1, 2, 3])
@pytest.mark.parametrize("group", list(GROUPS))
def test_index_form_bundle_matches_materialized(group, J):
    """DenseBundle's index form against the materialized oracle on the
    real rows of every exchange op, and its edge features."""
    N, M = GROUPS[group]
    db = _batch(group, 8, scale_w=False)
    b = bundles.DenseBundle.from_batch(db, J, with_line_graph=True)
    assert b.src is db.lg_src and b.rev.dtype == torch.int32
    mb = _materialized(_records(N, M, 8), N, M, J)
    gen = torch.Generator().manual_seed(J)
    nmask, emask = db.node_mask[..., None], db.edge_mask[..., None]
    x = torch.randn(8, N, 3, generator=gen, dtype=torch.float64) * nmask
    xl = torch.randn(8, M, 3, generator=gen, dtype=torch.float64) * emask
    for name, arg, rows in (("pm_pd", xl, nmask), ("lg_graph_op", xl, emask),
                            ("pm_pd_t", x, emask)):
        _close(getattr(b, name)(arg) * rows, getattr(mb, name)(arg),
               F64_RTOL, name)
    _close(b.edge_features(), mb.edge_features(), F64_RTOL, "edge features")


def _model_run(db, order, J, seed=0, composition=False, **kw):
    """A GNNLineGraph train step's output and gradients, through its own
    DenseBundle or, with composition, the one-hot composition."""
    m = models.GNNLineGraph(in_features=db.x.shape[2], n_features=2,
                            n_layers=3, J=J, order=order,
                            generator=torch.Generator().manual_seed(seed), **kw)
    m = m.to(db.x.dtype).train()
    y = m(db, bundle=_CompositionBundle(db, J, kw.get("dtype"))
          if composition else None)
    y.pow(2).sum().backward()
    return y.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


@pytest.mark.parametrize("order,J", [(1, 1), (2, 1), (3, 1), (1, 2), (2, 2),
                                     (3, 2)])
def test_gnn_line_graph_index_form_matches_composition(order, J):
    """GNNLineGraph in train mode, forward and backward, through the index
    form against the composition, in float64 at the 32/64 group."""
    db = _batch("n32_m64")
    _close_runs(_model_run(db, order, J),
                _model_run(db, order, J, composition=True), F64_RTOL)


def _close_runs(got, want, rtol):
    """Two _model_run results: outputs within rtol of the largest |output|,
    gradients within rtol of the largest |gradient|."""
    _close(got[0], want[0], rtol, "output")
    top = max(float(g.abs().max()) for g in want[1].values())
    for name, g in got[1].items():
        err = float((g.double() - want[1][name].double()).abs().max())
        assert err <= rtol * top, f"{name}: {err:.3e} over {top:.3e}"


@pytest.mark.parametrize("order", [1, 2, 3])
def test_lg_layer_whole_outputs_index_form(order):
    """An LGLayer's node and edge outputs on every row, padded ones
    included, through the index form and the composition."""
    db = _batch("n16_m32")
    layer = layers.LGLayer(5, 1, 2, J=2, order=order,
                           generator=torch.Generator().manual_seed(4)).double()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(db.x.shape, generator=gen, dtype=torch.float64)
    xl = torch.randn(db.lg_src.shape + (1,), generator=gen, dtype=torch.float64)
    got = layer(bundles.DenseBundle.from_batch(db, 2, with_line_graph=True),
                x, xl, db.node_mask, db.edge_mask)
    want = layer(_CompositionBundle(db, 2), x, xl, db.node_mask, db.edge_mask)
    for a, b, name in zip(got, want, ("node", "edge")):
        _close(a, b, F64_RTOL, name)


def _small_batch():
    db = _batch("n16_m32", count=3)
    return db, db.x.shape[1]


@pytest.mark.parametrize("op", OPS)
def test_functions_gradcheck_on_cpu(op):
    """Each autograd Function, whose wrappers run the plain versions on
    the CPU: its backward against finite differences of its forward, at
    a batch with padded edges."""
    db, N = _small_batch()
    src, dst, rev, em, w = _arrays(db)
    dl = X.nb_degrees(src, dst, rev, em, w, N)
    fns = {"pm_pd": lambda t: X.pm_pd(src, dst, em, t, N),
           "pm_pd_t": lambda t: X.pm_pd_t(src, dst, em, t),
           "nb": lambda t: X.nb_apply(src, dst, rev, em, w, t, N),
           "nb_full": lambda t: X.nb_apply(src, dst, rev, em, w, t, N, dl)}
    x = _input(op, db, 2, torch.Generator().manual_seed(3)).requires_grad_()
    assert torch.autograd.gradcheck(fns[op], (x,))


@pytest.mark.parametrize("device, dtype, want", [
    ("cuda", torch.float32, True),
    ("cpu", torch.float32, False),
    ("cuda", torch.bfloat16, False),
    ("cuda", torch.float64, False),
])
def test_dispatch_rule(device, dtype, want):
    assert X.use_kernel(torch.device(device), dtype) is want


def _launches():
    return {name: getattr(X, name).launches for name in WRAPPERS}


@pytest.mark.parametrize("case", ["cpu", "bfloat16", "float64", "bf16_rounding"])
def test_composition_paths_unchanged(case):
    """Off the kernel (the CPU in float32, float64, bf16 compute) the
    exchange runs the plain versions: no wrapper's launch count moves,
    and the model's output and gradients equal the run through the
    one-hot composition, within 1e-6 in float32, 1e-12 in float64 and
    2^-7 in bf16. bf16_rounding: the bf16 exchange (each op and a
    gradient) equals the float32 exchange of its bf16 inputs, rounded to
    bf16 once, bit for bit."""
    dtype = torch.float64 if case == "float64" else torch.float32
    db = _batch("n16_m32", dtype=dtype)
    kw = dict(dtype=torch.bfloat16) if case.startswith("bf") else {}
    before = _launches()
    if case != "bf16_rounding":
        got = _model_run(db, 2, 2, **kw)
        assert not X.use_kernel(db.lg_w.device, kw.get("dtype", dtype))
        assert _launches() == before
        rtol = {"cpu": CARD_RTOL, "float64": F64_RTOL, "bfloat16": BF16_RTOL}[case]
        _close_runs(got, _model_run(db, 2, 2, composition=True, **kw), rtol)
        return
    b = bundles.DenseBundle.from_batch(db, 1, with_line_graph=True, **kw)
    assert {t.dtype for t in (b.w, b.dl, b.edge_mask)} == {torch.bfloat16}
    f32 = bundles.DenseBundle(
        b.adj_powers.float(), b.deg.float(), 1, b.node_mask, b.src, b.dst,
        b.rev, b.w.float(), b.dl.float(), b.edge_mask.float())
    gen = torch.Generator().manual_seed(1)
    N, M = db.x.shape[1], db.lg_src.shape[1]
    for name, rows in (("pm_pd", M), ("pm_pd_t", N), ("lg_graph_op", M)):
        t = torch.randn(db.x.shape[0], rows, 2, generator=gen).bfloat16()
        t.requires_grad_()
        out = getattr(b, name)(t)
        assert out.dtype == torch.bfloat16, name
        assert torch.equal(out, getattr(f32, name)(t.float()).bfloat16()), name
        g = torch.randn(out.shape, generator=gen).bfloat16()
        (got,) = torch.autograd.grad(out, t, g)
        t32 = t.detach().float().requires_grad_()
        (want,) = torch.autograd.grad(getattr(f32, name)(t32), t32, g.float())
        assert torch.equal(got, want.bfloat16()), f"{name} gradient"
    assert _launches() == before


def test_index_form_taken_on_float32_with_the_rule(monkeypatch):
    """Every bundle, in float32, float64 and bf16 compute, holds the
    batch's own int32 arrays and takes dl from one nb_forward call."""
    real = X.nb_forward
    for dtype, compute in ((torch.float32, None), (torch.float64, None),
                           (torch.float32, torch.bfloat16)):
        calls = []
        monkeypatch.setattr(X, "nb_forward",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        db = _batch("n16_m32", dtype=dtype)
        b = bundles.DenseBundle.from_batch(db, 1, with_line_graph=True,
                                           dtype=compute)
        assert len(calls) == 1
        assert b.src is db.lg_src and b.dst is db.lg_dst and b.rev is db.lg_rev
        assert b.rev.dtype == torch.int32
        assert b.dl.dtype == (compute or dtype)


@pytest.mark.parametrize("kind, N, M, F, want", [
    ("to_nodes_pair", 16, 32, 2, 4), ("to_nodes_pair", 32, 64, 2, 2),
    ("to_nodes_sum", 32, 64, 5, 1), ("nb", 16, 32, 2, 2), ("nb", 32, 64, 2, 1),
    ("nb", 32, 64, 1, 2), ("nb", 4, 8, 1, 16), ("nb", 512, 2048, 2, 0),
    ("to_nodes_sum", 256, 1024, 5, 0),
])
def test_graphs_per_block(kind, N, M, F, want):
    """About one item a thread, at least one graph, and only what fits the
    shared memory a block stages; 0 (looped) where one graph does not."""
    G = X._graphs_per_block(kind, N, M, F)
    assert G == want
    if G:
        assert 4 * G * X._graph_words(kind, N, M, F) <= X.SMEM_BYTES
    else:
        assert 4 * X._graph_words(kind, N, M, F) > X.SMEM_BYTES


@pytest.mark.parametrize("bad, msg", [
    ("index_dtype", "src is torch.int64"), ("mask_dtype", "emask is"),
    ("shape", "features must be"), ("rev_shape", "rev must be"),
    ("odd_gradient", "features must be"), ("full_gradient", "features must be"),
])
def test_wrappers_refuse_bad_inputs(bad, msg):
    """The wrappers' checks, the same on the CPU as on the card: index
    dtypes, the mask's dtype, the features' and indices' shapes, and a
    backward's gradient width (2F for the pairs, 3F for the NB apply's
    whole output)."""
    db = _batch("n16_m32", count=3)
    src, dst, rev, em, w = _arrays(db)
    N, M = db.x.shape[1], src.shape[1]
    xl = torch.randn(3, M, 2, dtype=torch.float64)
    if bad == "index_dtype":
        src = src.long()
    elif bad == "mask_dtype":
        em = em.float()
    elif bad == "shape":
        xl = xl[:, :-1]
    elif bad == "rev_shape":
        rev = rev[:, :-1]
    with pytest.raises((ValueError, TypeError), match=msg):
        if bad == "odd_gradient":
            X.pm_pd_backward(src, dst, em, torch.randn(3, N, 3, dtype=torch.float64))
        elif bad == "full_gradient":
            X.nb_backward(src, dst, rev, em, w, torch.randn(3, M, 4, dtype=torch.float64),
                          N, w)
        else:
            X.nb_forward(src, dst, rev, em, w, xl, N)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


CELL_BATCH = 2048


def _cell_batch(group: str, dev):
    """2,048 molecules of the group's shape in float32 on the card."""
    N, M = GROUPS[group]
    recs = _records(N, M, CELL_BATCH, seed=3)
    assert len(recs) == CELL_BATCH
    return graphs.make_dense_batch(recs, n_max=N, m_max=M, with_line_graph=True,
                                   task=0, device=dev)


def _looped_batch(dev):
    """Three random graphs of 256 node and 2,048 edge slots, too large to
    stage: src and dst anywhere, rev a random involution of the real
    edges, padded edges with rev = 0."""
    gen = torch.Generator().manual_seed(11)
    B, N, M, real = 3, 256, 2048, 1900
    src = torch.randint(0, N, (B, M), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (B, M), generator=gen, dtype=torch.int32)
    rev = torch.zeros(B, M, dtype=torch.int32)
    for b in range(B):
        p = torch.randperm(real, generator=gen)
        rev[b, p[0::2]] = p[1::2].int()
        rev[b, p[1::2]] = p[0::2].int()
    em = torch.zeros(B, M)
    em[:, :real] = 1.0
    src[:, real:] = dst[:, real:] = rev[:, real:] = 0
    w = torch.rand(B, M, generator=gen) * em
    return [t.to(dev) for t in (src, dst, rev, em, w)], N


def _card_cases(case, dev):
    if case == "looped":
        arrays, N = _looped_batch(dev)
        return arrays, N
    db = _cell_batch(case, dev)
    return list(_arrays(db)), db.x.shape[1]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F", [1, 2, 5])
@pytest.mark.parametrize("case", [*GROUPS, "looped"])
def test_kernels_match_plain_and_composition_on_the_card(cuda, case, F):
    """Each kernel against its plain version on the CPU bit for bit, and
    each differentiable op's output and gradient against the composition
    on the card; one launch of each raw wrapper a call."""
    (src, dst, rev, em, w), N = _card_cases(case, cuda)
    if case == "looped":
        assert X._graphs_per_block("nb", N, src.shape[1], F) == 0
    cpu = [t.cpu() for t in (src, dst, rev, em, w)]
    B, M = src.shape
    gen = torch.Generator().manual_seed(F)
    dl = X.nb_degrees(src, dst, rev, em, w, N)
    dl_cpu = X.nb_degrees(*cpu, N)
    assert torch.equal(dl.cpu(), dl_cpu)
    cs, cd, cr, ce, cw = cpu
    kernel = {
        "pm_pd_forward": (lambda t: X.pm_pd_forward(src, dst, em, t, N),
                          lambda t: X.pm_pd_forward(cs, cd, ce, t, N), (B, M, F)),
        "pm_pd_backward": (lambda t: X.pm_pd_backward(src, dst, em, t),
                           lambda t: X.pm_pd_backward(cs, cd, ce, t), (B, N, 2 * F)),
        "pm_pd_t_forward": (lambda t: X.pm_pd_t_forward(src, dst, em, t),
                            lambda t: X.pm_pd_t_forward(cs, cd, ce, t), (B, N, F)),
        "pm_pd_t_backward": (lambda t: X.pm_pd_t_backward(src, dst, em, t, N),
                             lambda t: X.pm_pd_t_backward(cs, cd, ce, t, N),
                             (B, M, 2 * F)),
        "nb_forward": (lambda t: X.nb_forward(src, dst, rev, em, w, t, N, dl),
                       lambda t: X.nb_forward(cs, cd, cr, ce, cw, t, N, dl_cpu),
                       (B, M, F)),
        "nb_backward": (lambda t: X.nb_backward(src, dst, rev, em, w, t, N, dl),
                        lambda t: X.nb_backward(cs, cd, cr, ce, cw, t, N, dl_cpu),
                        (B, M, 3 * F)),
        "nb_apply_forward": (lambda t: X.nb_forward(src, dst, rev, em, w, t, N),
                             lambda t: X.nb_forward(cs, cd, cr, ce, cw, t, N),
                             (B, M, F)),
        "nb_apply_backward": (lambda t: X.nb_backward(src, dst, rev, em, w, t, N),
                              lambda t: X.nb_backward(cs, cd, cr, ce, cw, t, N),
                              (B, M, F)),
    }
    for name, (on_card, on_cpu, shape) in kernel.items():
        t = torch.randn(shape, generator=gen)
        counter = getattr(X, name.replace("nb_apply", "nb"))
        before = counter.launches
        got = on_card(t.to(cuda))
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        assert torch.equal(got.cpu(), on_cpu(t)), name

    s_src, s_dst = D.edge_scatter_matrices(src, dst, em, N)
    dl_c = D.nb_degrees(s_src, s_dst, w, rev.long()) * em
    _close(dl, dl_c, CARD_RTOL, "dl")
    comp = {
        "pm_pd": (lambda t: torch.cat([D.incidence_apply(s_src, s_dst, t, False),
                                       D.incidence_apply(s_src, s_dst, t, True)], -1),
                  lambda t: X.pm_pd(src, dst, em, t, N), M),
        "pm_pd_t": (lambda t: torch.cat([D.incidence_t_apply(s_src, s_dst, t, False),
                                         D.incidence_t_apply(s_src, s_dst, t, True)], -1),
                    lambda t: X.pm_pd_t(src, dst, em, t), N),
        "nb": (lambda t: D.nb_apply(s_src, s_dst, w, rev.long(), t),
               lambda t: X.nb_apply(src, dst, rev, em, w, t, N), M),
        "nb_full": (lambda t: D.lg_graph_op(s_src, s_dst, w, rev.long(), dl_c, t,
                                            1, em),
                    lambda t: X.nb_apply(src, dst, rev, em, w, t, N, dl), M),
    }
    for name, (composed, index, rows) in comp.items():
        t = torch.randn(B, rows, F, generator=gen).to(cuda).requires_grad_()
        want = composed(t)
        g = torch.randn(want.shape, generator=gen).to(cuda)
        (want_g,) = torch.autograd.grad(want, t, g)
        got = index(t)
        (got_g,) = torch.autograd.grad(got, t, g)
        _close(got, want, CARD_RTOL, name)
        _close(got_g, want_g, CARD_RTOL, f"{name} gradient")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_plain_versions_on_the_card(cuda, dtype):
    """Off float32 on the card (float64, bf16 compute) the bundle's
    exchange runs the plain versions there: no launch is counted, and
    each op and its gradient equal the CPU's within the dtype's tolerance
    (index_add_ on the card sums in another order)."""
    db = _batch("n16_m32", dtype=torch.float64 if dtype == torch.float64
                else torch.float32)
    compute = None if dtype == torch.float64 else dtype
    cpu = bundles.DenseBundle.from_batch(db, 2, with_line_graph=True,
                                         dtype=compute)
    card = bundles.DenseBundle.from_batch(db.to(cuda), 2, with_line_graph=True,
                                          dtype=compute)
    rtol = F64_RTOL if dtype == torch.float64 else BF16_RTOL
    before = _launches()
    gen = torch.Generator().manual_seed(2)
    N, M = db.x.shape[1], db.lg_src.shape[1]
    for name, rows in (("pm_pd", M), ("pm_pd_t", N), ("lg_graph_op", M)):
        t = torch.randn(db.x.shape[0], rows, 2, generator=gen).to(dtype)
        g = torch.randn(getattr(cpu, name)(t).shape, generator=gen).to(dtype)
        results = []
        for b, dev in ((cpu, "cpu"), (card, cuda)):
            x = t.to(dev).requires_grad_()
            out = getattr(b, name)(x)
            (grad,) = torch.autograd.grad(out, x, g.to(dev))
            assert out.dtype == dtype, name
            results.append((out, grad))
        _close(results[1][0], results[0][0], rtol, name)
        _close(results[1][1], results[0][1], rtol, f"{name} gradient")
    assert _launches() == before


# the line-graph cell's model: GNNLineGraph L 5, h 1, J 1, order 2; the
# index-form launches of one train step (4 layers and the readout):
# forward, Pm/Pd 4 + 1, Pm^T/Pd^T 4, NB 4 + 1 (the bundle's dl); backward,
# all but layer 0's Pm^T/Pd^T (of the batch's x) and NB (of dl)
STEP_LAUNCHES = {"pm_pd_forward": 5, "pm_pd_backward": 5,
                 "pm_pd_t_forward": 4, "pm_pd_t_backward": 3,
                 "nb_forward": 5, "nb_backward": 3}
# the kernels a replayed step runs, by name
STEP_KERNELS = {"lg_to_nodes": 5 + 3, "lg_to_edges": 4 + 5, "lg_nb_forward": 5,
                "lg_nb_backward": 3}
_LG_KERNEL = re.compile(r"(lg_to_nodes|lg_to_edges|lg_nb_forward|lg_nb_backward)")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("group", list(GROUPS))
def test_captured_step_matches_eager(cuda, group):
    """A GNNLineGraph train step (forward and backward) captured in a CUDA
    graph and replayed on another batch of the same shape gives the eager
    step's output and gradients bit for bit; the capture calls each
    wrapper STEP_LAUNCHES times, and a replay runs STEP_KERNELS of the
    kernels by name and moves no counter."""
    from torch.profiler import ProfilerActivity, profile

    N, M = GROUPS[group]
    recs = _records(N, M, 2 * CELL_BATCH, seed=3)
    assert len(recs) == 2 * CELL_BATCH
    make = lambda rs: graphs.make_dense_batch(rs, n_max=N, m_max=M,
                                              with_line_graph=True, task=0,
                                              device=cuda)
    static, other = make(recs[:CELL_BATCH]), make(recs[CELL_BATCH:])
    model = models.GNNLineGraph(in_features=static.x.shape[2], n_features=1,
                                n_layers=5, J=1, order=2,
                                generator=torch.Generator().manual_seed(3))
    model = model.to(cuda).train()
    g_in = torch.randn(CELL_BATCH, 1, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(5))

    def body():
        model.zero_grad(set_to_none=False)
        out = model(static)
        out.backward(g_in)
        return out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    counters = {k: getattr(X, k) for k in STEP_LAUNCHES}
    before = {k: c.launches for k, c in counters.items()}
    with torch.cuda.graph(graph):
        out_g = body()
    assert {k: c.launches - before[k] for k, c in counters.items()} == STEP_LAUNCHES
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for name in static.__dict__:
            t = getattr(static, name)
            if torch.is_tensor(t):
                t.copy_(getattr(other, name))
    before = {k: c.launches for k, c in counters.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    assert {k: c.launches for k, c in counters.items()} == before
    seen = {}
    for e in prof.key_averages():
        k = _LG_KERNEL.search(e.key)
        if k:
            seen[k.group(1)] = seen.get(k.group(1), 0) + e.count
    assert seen == STEP_KERNELS, seen
    replayed = [out_g.clone()] + [p.grad.clone() for p in model.parameters()]
    model.load_state_dict(state)  # the replay's batch norms moved the stats
    model.zero_grad(set_to_none=False)
    out = model(other)
    out.backward(g_in)
    eager = [out.detach()] + [p.grad for p in model.parameters()]
    torch.cuda.synchronize()
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
