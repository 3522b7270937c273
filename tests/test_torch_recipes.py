"""The port's recipes (hgnn2_torch/scripts/exp_*.sh) against their JAX
twins (scripts/exp_*.sh): each recipe's command line, with its
environment defaults (BS, EPOCHS, TASK, K, N) filled in as the shell
would, parses through the port's entry point into the same TrainConfig
as the twin's line through JAX's, the port's device apart; nothing
trains."""

import dataclasses
import importlib
import os
import re
import shlex

import pytest

pytest.importorskip("jax")

from hgnn2_tpu.cli import common as jcommon

from hgnn2_torch.cli import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["exp_gnn_qm9", "exp_lggnn_qm9", "exp_ccn1_qm9", "exp_ccn2_qm9",
           "exp_gnn_col", "exp_ccn_col"]


def _command(path: str, env: dict) -> tuple[str, list[str]]:
    """(module, argv) of the recipe's python -m line, continuation lines
    joined and ${VAR:-default} expanded from env or the default."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(l for l in text.splitlines() if l.startswith("python -m "))
    line = re.sub(r"\$\{(\w+):-([^}]*)\}",
                  lambda m: env.get(m.group(1), m.group(2)), line)
    words = shlex.split(line)
    assert words[-1] == "$@"  # extra flags pass through
    return words[2], words[3:-1]


def _flat(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _config(monkeypatch, module: str, argv, common_module):
    seen = []
    monkeypatch.setattr(common_module, "run_experiment",
                        lambda cfg, **kw: seen.append(cfg))
    importlib.import_module(module).main(argv)
    return _flat(seen[0])


@pytest.mark.parametrize("env", [{}, {"BS": "64", "EPOCHS": "3", "TASK": "2",
                                      "K": "2", "N": "300"}])
@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses_to_jax_twin_config(monkeypatch, name, env):
    mine = os.path.join(REPO, "hgnn2_torch", "scripts", f"{name}.sh")
    theirs = os.path.join(REPO, "scripts", f"{name}.sh")
    assert os.access(mine, os.X_OK)
    module, argv = _command(mine, env)
    jmodule, jargv = _command(theirs, env)
    assert module == jmodule.replace("hgnn2_tpu.", "hgnn2_torch.")
    assert argv == jargv
    got = _config(monkeypatch, module, argv, common)
    want = _config(monkeypatch, jmodule, jargv, jcommon)
    assert got.pop("device") == "cuda"
    assert got == want
    if "BS" in env:
        assert got["batch_size"] == 64 and got["epochs"] == 3
