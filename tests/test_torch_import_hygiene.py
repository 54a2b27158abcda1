"""The port stands alone: no file of ``ray_tpu_torch`` nor ``chip_smoke.py``
imports JAX or anything of ``ray_tpu``, and its entry points run on the
card unless the caller asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root.startswith("jax") or root == "ray_tpu"


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(m for m in _imported_modules(tree) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_the_card():
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      init_state, make_optimizer,
                                      params_from_jax)
    cfg = TransformerConfig(vocab_size=32, d_model=64, n_layers=1,
                            n_heads=1, n_kv_heads=1, d_ff=64)
    tx = make_optimizer()
    state = init_state(cfg, tx, device="cpu")
    assert state.step == 0 and state.params["embed"].device.type == "cpu"
    assert state.opt_state.mu[0].device.type == "cpu"
    params = init_params(cfg, device="cpu")
    tree = {k: (np.asarray(v) if k != "blocks" else
                [{n: np.asarray(t) for n, t in b.items()} for b in v])
            for k, v in params.items()}
    assert params_from_jax(tree, device="cpu")["embed"].device.type == "cpu"
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
        assert params_from_jax(tree)["embed"].device.type == "cuda"
        assert init_state(cfg, tx).params["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(cfg, tx)
