"""The slice as a whole against the JAX package: the counterpart of
``tests/test_serve.py::test_jitted_model_replica``. The tiny flagship is
deployed under each package's Serve on the same numpy weights, and the
handle's answers agree to 2e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch

TINY = dict(vocab_size=128, d_model=32, n_heads=2, n_kv_heads=2,
            n_layers=1, d_ff=64, max_seq_len=16, use_flash=True)
LOGITS_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tiny_flagship_deployment(serve_mod, weights, accel_options):
    """The tiny flagship as a class deployment of ``serve_mod``: its
    replica builds the model from the numpy ``weights`` at construction
    and answers a token list with the last position's logits. The JAX
    package's replica jit-compiles the forward (the reference case);
    the port's runs ``forward`` under ``inference_mode``."""
    if serve_mod.__name__.startswith("ray_tpu_torch"):
        @serve_mod.deployment(ray_actor_options=accel_options)
        class Model:
            def __init__(self, weights):
                from ray_tpu_torch.models import (TransformerConfig,
                                                  params_from_jax)
                self.cfg = TransformerConfig(**TINY, dtype=torch.float32)
                self.params = params_from_jax(weights, device="cpu")
                self(list(range(8)))        # warm at init

            def __call__(self, token_list):
                from ray_tpu_torch.models.transformer import forward
                with torch.inference_mode():
                    logits = forward(self.params,
                                     torch.tensor([token_list]), self.cfg)
                return [float(x) for x in logits[0, -1]]
    else:
        @serve_mod.deployment(ray_actor_options=accel_options)
        class Model:
            def __init__(self, weights):
                import jax
                import jax.numpy as jnp
                from ray_tpu.models.transformer import (TransformerConfig,
                                                        forward)
                self.cfg = TransformerConfig(**TINY, dtype=jnp.float32)
                self.params = jax.tree.map(jnp.asarray, weights)
                self._fwd = jax.jit(lambda p, t: forward(p, t, self.cfg))
                self(list(range(8)))        # compile at init

            def __call__(self, token_list):
                import jax.numpy as jnp
                tokens = jnp.asarray([token_list], dtype=jnp.int32)
                logits = self._fwd(self.params, tokens)
                return [float(x) for x in logits[0, -1]]
    return Model.bind(weights)


@pytest.mark.parametrize("placement", ["accelerator", "process"])
def test_jitted_model_replica_matches_the_jax_package(placement):
    """The flagship serving shape, held against the JAX package: the
    tiny flagship (vocab 128, d_model 32, one layer, flash attention,
    fp32) from the same numpy weights (the JAX package's ``init_params``
    at seed 0, carried across by ``params_from_jax``) is deployed under
    each package's Serve, on an accelerator replica (``num_tpus=1`` /
    ``num_gpus=1``, a thread of the driver) or in a process worker, and
    the handle's answers agree to 2e-5."""
    import jax
    import jax.numpy as jnp

    import ray_tpu
    from ray_tpu.models import transformer as jt

    weights = jax.tree.map(np.asarray, jt.init_params(
        jax.random.PRNGKey(0),
        jt.TransformerConfig(**TINY, dtype=jnp.float32)))
    queries = np.random.RandomState(1).randint(0, 128, (3, 8)).tolist()
    answers = []
    for rt, accel in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        rt.init(num_cpus=4, **{accel: 8}, max_process_workers=1)
        serve_mod = importlib.import_module(rt.__name__ + ".serve")
        try:
            options = {accel: 1} if placement == "accelerator" else {}
            handle = serve_mod.run(_tiny_flagship_deployment(
                serve_mod, weights, options))
            answers.append(np.asarray(rt.get(
                [handle.remote(q) for q in queries], timeout=180)))
        finally:
            serve_mod.shutdown()
            rt.shutdown()
    ref, port = answers
    assert port.shape == ref.shape == (3, 128)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=LOGITS_TOL, rtol=0)
