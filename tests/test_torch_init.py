"""The initial weights of every model of run_validation's RUNS, in the port
and in the JAX package: the port's parameters and BN buffers map one to
one onto JAX's variables through hgnn2_torch.convert (names, shapes);
each parameter, pooled over the draws of seeds 0-7 (the port's
common.build_model under cfg.seed, JAX's model.init under
jax.random.key(seed), as TrainState.create draws), has the sample mean
and standard deviation of N(0, 0.1) within 5 standard errors in both
packages; and the BN running statistics start equal. So a run's quality
differs between the packages by the draw it starts from, not by the
distribution it is drawn from.

Standard errors of n pooled values: 0.1 / sqrt(n) for the mean,
0.1 / sqrt(2 n) for the standard deviation."""

import importlib.util
import os
import sys
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu import runtime as jruntime
from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.nn import ccn as jccn

from hgnn2_torch import convert
from hgnn2_torch.cli import common
from hgnn2_torch.scripts import run_validation as rv

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = range(8)
SCALE = 0.1  # ref_init's N(0, 0.1) in both packages
SIGMAS = 5.0


def _jax_runs():
    """scripts/run_validation.py's RUNS, without its runtime.setup()."""
    spec = importlib.util.spec_from_file_location(
        "jax_script_run_validation_init",
        os.path.join(ROOT, "scripts", "run_validation.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jruntime, "setup", lambda *a, **k: None), \
            mock.patch.dict(sys.modules, {}):
        spec.loader.exec_module(mod)
    return mod.RUNS


JRUNS = _jax_runs()


def _to_port(arch: str, variables) -> dict:
    variables = jax.tree.map(np.asarray, variables)
    if arch.startswith("ccn"):
        return convert.ccn_params_from_flax(variables["params"])
    return convert.dense_variables_from_flax(variables)


def _draws(name: str):
    """(port draws, JAX draws converted to the port's layout, the port's
    parameter names): a state_dict a seed in each package."""
    cfg, jcfg = rv.RUNS[name](), JRUNS[name]()
    for c in (cfg, jcfg):
        c.data.n_synthetic = 40
    cfg.device = "cpu"
    records, kind, _, _ = common.load_records(cfg)
    jrecords, jkind, _, _ = jcommon.load_records(jcfg)
    assert kind == jkind
    arch = cfg.model.arch
    if arch.startswith("ccn"):
        sample = jccn.make_ccn_batch(jrecords[:8])
    else:
        sample = jgraphs.make_dense_batch(jrecords[:8],
                                          with_line_graph=arch == "lggnn")
    jmodel = jcommon.build_model(jcfg, jkind)
    init = jax.jit(jmodel.init, static_argnames="train")
    mine, theirs, names = [], [], None
    for seed in DRAWS:
        cfg.seed = seed
        model = common.build_model(cfg, kind, records[0].x.shape[1])
        mine.append({k: v.detach().clone() for k, v in
                     model.state_dict().items()})
        names = names or {n for n, _ in model.named_parameters()}
        theirs.append(_to_port(arch, init(jax.random.key(seed), sample,
                                          train=True)))
    return mine, theirs, names


@pytest.mark.parametrize("name", list(rv.RUNS))
def test_initial_draws_follow_the_same_distribution(name):
    mine, theirs, names = _draws(name)
    # one to one: the converted JAX variables name and shape every entry
    for port, jax_ in zip(mine, theirs):
        assert port.keys() == jax_.keys()
        for k, v in port.items():
            assert tuple(v.shape) == tuple(jax_[k].shape), k
    assert names and names <= set(mine[0])
    for k in sorted(names):
        for who, draws in (("port", mine), ("jax", theirs)):
            vals = np.concatenate([d[k].numpy().ravel() for d in draws])
            n = vals.size
            mean_z = abs(vals.mean()) / (SCALE / np.sqrt(n))
            std_z = abs(vals.std() - SCALE) / (SCALE / np.sqrt(2 * n))
            assert mean_z < SIGMAS and std_z < SIGMAS, (
                f"{who} {k}: mean {vals.mean():.4g}, std {vals.std():.4g} "
                f"over {n} values")
    # the BN running statistics (buffers) start equal, at every draw
    for port, jax_ in zip(mine, theirs):
        for k in set(port) - names:
            torch.testing.assert_close(port[k], jax_[k], rtol=0, atol=0,
                                       msg=k)
