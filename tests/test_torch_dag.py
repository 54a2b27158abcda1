"""The port's DAGs (``ray_tpu_torch.dag``): every case of
``tests/test_dag.py`` on ``ray_tpu_torch``, then the port against the
JAX package on the same numpy inputs:

- ``compile_to_jit`` of a pure-function DAG against the JAX package's
  jitted program, at fp32 to 1e-5;
- the tiny flagship's forward split into DAG nodes (embedding, one node
  a block, the head): the port's composition against its direct
  ``forward`` bit for bit, and against the JAX package's
  ``compile_to_jit`` of the same split within the transformer tests'
  2e-5;
- ``is_fast`` of a DAG whose second stage is an accelerator actor
  (``num_gpus=1`` in the port, ``num_tpus=1`` in the JAX package), which
  both packages decide alike, with equal answers;
- ``.bind`` on a remote function, an ``.options`` copy and an actor
  method builds DAG nodes.

The port's ``compile_to_jit`` composes the nodes' functions eagerly
(there is no ``jax.jit`` to lower into); on CUDA tensors the flagship's
forward launches the flash kernel, which the ``cuda`` case counts.
"""

import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag import (ClassMethodNode, FunctionNode, InputNode,
                               MultiOutputNode, compile_to_jit)

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=352, max_seq_len=128, use_flash=True)
JIT_TOL = 1e-5
LOGITS_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """The reference's fixture on the port: 4 CPUs, 2 process workers and
    8 GPUs of resource, whose work runs on driver threads."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


# -- the cases of tests/test_dag.py -----------------------------------------

def test_function_dag(ray_start_regular):
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp), 10)
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(5)) == 20
    assert ray_tpu_torch.get(compiled.execute(7)) == 24   # replayable


def test_actor_dag(ray_start_regular):
    @ray_tpu_torch.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    @ray_tpu_torch.remote
    def square(x):
        return x * x

    acc = Acc.remote()
    with InputNode() as inp:
        dag = acc.add.bind(square.bind(inp))
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(2)) == 4
    assert ray_tpu_torch.get(compiled.execute(3)) == 13   # stateful actor


def test_multi_output_dag(ray_start_regular):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    @ray_tpu_torch.remote
    def dec(x):
        return x - 1

    with InputNode() as inp:
        dag = MultiOutputNode([inc.bind(inp), dec.bind(inp)])
    refs = dag.experimental_compile().execute(10)
    assert ray_tpu_torch.get(refs) == [11, 9]


def test_compile_to_jit_single_program(ray_start_regular):
    """A pure-function DAG composes into ONE callable."""
    @ray_tpu_torch.remote
    def matmul(x):
        return x @ x.T

    @ray_tpu_torch.remote
    def relu_sum(y):
        return torch.sum(torch.clamp_min(y, 0.0))

    with InputNode() as inp:
        dag = relu_sum.bind(matmul.bind(inp))
    fn = compile_to_jit(dag)
    x = torch.arange(12.0).reshape(3, 4)
    expected = float(torch.sum(torch.clamp_min(x @ x.T, 0.0)))
    assert float(fn(x)) == pytest.approx(expected)
    assert float(fn(x + 1)) == pytest.approx(
        float(torch.sum(torch.clamp_min((x + 1) @ (x + 1).T, 0.0))))


def test_compile_to_jit_rejects_actor_nodes(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def f(self, x):
            return x

    a = A.remote()
    with InputNode() as inp:
        dag = a.f.bind(inp)
    with pytest.raises(TypeError, match="pure-function"):
        compile_to_jit(dag)(1)


def test_compiled_actor_dag_fast_path(ray_start_regular):
    """An all-actor DAG engages the channel fast path: constants are
    pre-serialized, worker channels pre-bound, and the stage handoff
    never materializes in the driver's store."""
    import ray_tpu_torch._private.worker as worker_mod

    @ray_tpu_torch.remote
    class Stage:
        def scale(self, x, k):
            return [v * k for v in x]

        def total(self, x):
            return sum(x)

    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        dag = b.total.bind(a.scale.bind(inp, 3))
    compiled = dag.experimental_compile()
    assert compiled.is_fast

    w = worker_mod.global_worker()
    stored = []
    orig = w.task_manager._store_result

    def spy(oid, entry):
        stored.append(oid)
        return orig(oid, entry)

    w.task_manager._store_result = spy
    try:
        ref = compiled.execute([1, 2, 3])
        assert ray_tpu_torch.get(ref) == 18
    finally:
        w.task_manager._store_result = orig
    # Only the TERMINAL result reached the driver; the a->b handoff rode
    # the worker-to-worker channel.
    assert stored == [ref.id()]


def test_compiled_dag_pre_serialized_big_constant(ray_start_regular):
    """Constants past the inline limit are promoted to a driver-store
    object at COMPILE time and referenced by descriptor per execute."""
    @ray_tpu_torch.remote
    class M:
        def dot(self, x, w):
            return float((x * w).sum())

    big = np.ones(300_000, dtype=np.float64)   # ~2.4 MB
    m = M.remote()
    with InputNode() as inp:
        dag = m.dot.bind(inp, big)
    compiled = dag.experimental_compile()
    assert compiled.is_fast
    kind = [d for k, d in compiled._stages[0].arg_plan if k == "c"][0][0]
    assert kind == "shm"
    assert ray_tpu_torch.get(compiled.execute(np.full_like(big, 2.0))) == \
        pytest.approx(600_000.0)
    assert ray_tpu_torch.get(compiled.execute(np.full_like(big, 3.0))) == \
        pytest.approx(900_000.0)


def test_compiled_dag_error_propagates_through_channel(ray_start_regular):
    """A failing upstream stage publishes its error INTO the channel;
    the terminal ref carries the cause instead of a timeout."""
    @ray_tpu_torch.remote
    class S:
        def boom(self, x):
            raise ValueError("stage exploded")

        def consume(self, x):
            return x

    a, b = S.remote(), S.remote()
    with InputNode() as inp:
        dag = b.consume.bind(a.boom.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.is_fast
    with pytest.raises(Exception, match="stage exploded"):
        ray_tpu_torch.get(compiled.execute(1), timeout=30)


def test_compiled_dag_multi_output_and_fanout(ray_start_regular):
    """One stage feeding two consumers uses a consumer-counted channel."""
    @ray_tpu_torch.remote
    class S:
        def prep(self, x):
            return x + 1

        def double(self, x):
            return x * 2

        def negate(self, x):
            return -x

    a, b, c = S.remote(), S.remote(), S.remote()
    with InputNode() as inp:
        mid = a.prep.bind(inp)
        dag = MultiOutputNode([b.double.bind(mid), c.negate.bind(mid)])
    compiled = dag.experimental_compile()
    assert compiled.is_fast
    assert ray_tpu_torch.get(compiled.execute(4)) == [10, -5]
    assert ray_tpu_torch.get(compiled.execute(0)) == [2, -1]


def test_compiled_dag_dispatch_beats_uncompiled(ray_start_regular):
    """The point of compiling, held by the event rather than by wall
    time: a compiled execute of a 2-stage actor pipeline brings ONE value
    into the driver (the terminal result; the handoff rides the
    pre-bound channel), where the same calls chained by ``.remote``
    bring two (the intermediate result comes back to the driver before
    the second stage can run). Routing the compiled handoff back through
    the driver, the gross regression the reference's best-of-N timing
    guards against, would make the two counts equal."""
    import ray_tpu_torch._private.worker as worker_mod

    @ray_tpu_torch.remote
    class P:
        def f(self, x):
            return x

    a, b = P.remote(), P.remote()
    with InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.is_fast

    w = worker_mod.global_worker()
    stored = []
    orig = w.task_manager._store_result

    def spy(oid, entry):
        stored.append(oid)
        return orig(oid, entry)

    def count(run, n=10):
        del stored[:]
        for i in range(n):
            assert run(i) == i
        return len(stored)

    w.task_manager._store_result = spy
    try:
        uncompiled = count(
            lambda i: ray_tpu_torch.get(b.f.remote(a.f.remote(i))))
        fast = count(lambda i: ray_tpu_torch.get(compiled.execute(i)))
    finally:
        w.task_manager._store_result = orig
    assert (fast, uncompiled) == (10, 20)


def test_compiled_dag_same_actor_consumes_twice(ray_start_regular):
    """Two consumer stages hosted by the SAME actor get ONE aggregated
    push with a combined take budget."""
    @ray_tpu_torch.remote
    class S:
        def prep(self, x):
            return x + 1

        def double(self, x):
            return x * 2

        def negate(self, x):
            return -x

        def combine(self, p, q):
            return (p, q)

    a, b = S.remote(), S.remote()
    with InputNode() as inp:
        mid = a.prep.bind(inp)
        dag = MultiOutputNode([b.double.bind(mid), b.negate.bind(mid)])
    compiled = dag.experimental_compile()
    assert compiled.is_fast
    assert ray_tpu_torch.get(compiled.execute(4), timeout=30) == [10, -5]
    # same upstream value used twice in ONE stage's args
    with InputNode() as inp:
        mid = a.prep.bind(inp)
        dag2 = b.combine.bind(mid, mid)
    compiled2 = dag2.experimental_compile()
    assert compiled2.is_fast
    assert ray_tpu_torch.get(compiled2.execute(1), timeout=30) == (2, 2)


def test_compiled_dag_teardown_invalidates(ray_start_regular):
    @ray_tpu_torch.remote
    class S:
        def f(self, x):
            return x

    s = S.remote()
    with InputNode() as inp:
        dag = s.f.bind(inp)
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(1)) == 1
    compiled.teardown()
    with pytest.raises(ValueError, match="torn down"):
        compiled.execute(2)


def test_compiled_dag_concurrent_big_handoffs(ray_start_regular):
    """Many in-flight executes with >inline-limit stage handoffs: each
    channel gets its own shm segment."""
    @ray_tpu_torch.remote
    class S:
        def expand(self, i):
            return np.full(40_000, float(i))   # ~320 KB > inline limit

        def reduce(self, x):
            return float(x.sum())

    a, b = S.remote(), S.remote()
    with InputNode() as inp:
        dag = b.reduce.bind(a.expand.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled.is_fast
    refs = [compiled.execute(i) for i in range(16)]
    assert ray_tpu_torch.get(refs) == [40_000.0 * i for i in range(16)]


def test_mixed_dag_falls_back_to_replay(ray_start_regular):
    """Task nodes in the DAG disable the channel fast path but the DAG
    still executes correctly via replay."""
    @ray_tpu_torch.remote
    def square(x):
        return x * x

    @ray_tpu_torch.remote
    class Acc:
        def add(self, x):
            return x + 100

    acc = Acc.remote()
    with InputNode() as inp:
        dag = acc.add.bind(square.bind(inp))
    compiled = dag.experimental_compile()
    assert not compiled.is_fast
    assert ray_tpu_torch.get(compiled.execute(3)) == 109


def test_dag_cycle_detection(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x

    node = f.bind(1)
    node.args = (node,)   # forge a cycle
    with pytest.raises(ValueError, match="cycle"):
        node.experimental_compile()


# -- the port against the JAX package ----------------------------------------

def test_bind_builds_dag_nodes():
    """``.bind`` is public API: a remote function, an ``.options`` copy
    and an actor method each build a node (no runtime needed to bind a
    function)."""
    @ray_tpu_torch.remote
    def f(x):
        return x

    node = f.bind(1)
    assert isinstance(node, FunctionNode) and node.args == (1,)
    assert isinstance(f.options(max_retries=2).bind(node), FunctionNode)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        @ray_tpu_torch.remote
        class A:
            def g(self, x):
                return x

        a = A.remote()
        method_node = a.g.bind(node)
        assert isinstance(method_node, ClassMethodNode)
        assert method_node.args == (node,)
        assert ray_tpu_torch.get(method_node.execute()) == 1
    finally:
        ray_tpu_torch.shutdown()


def _pure_functions(rt, xp):
    """The same three-node pure DAG under either package: ``xp`` is
    ``jax.numpy`` or ``torch``."""
    @rt.remote
    def project(x, w):
        return x @ w

    @rt.remote
    def gelu_norm(y):
        if xp is torch:
            act = torch.nn.functional.gelu(y, approximate="tanh")
            return act / torch.sqrt(torch.mean(act * act, -1,
                                               keepdim=True) + 1e-6)
        import jax
        act = jax.nn.gelu(y, approximate=True)
        return act / xp.sqrt(xp.mean(act * act, -1, keepdims=True) + 1e-6)

    amax = torch.amax if xp is torch else xp.max

    @rt.remote
    def pool(z, y):
        return xp.sum(z, 0), amax(y, 0)

    dag_mod = importlib.import_module(f"{rt.__name__}.dag")
    with dag_mod.InputNode(0) as x, dag_mod.InputNode(1) as w:
        y = project.bind(x, w)
        dag = pool.bind(gelu_norm.bind(y), y)
    return dag


def test_compile_to_jit_matches_the_jax_package():
    import jax.numpy as jnp
    import ray_tpu
    from ray_tpu.dag import compile_to_jit as jax_compile_to_jit

    rs = np.random.RandomState(0)
    x = rs.standard_normal((64, 48)).astype(np.float32)
    w = rs.standard_normal((48, 32)).astype(np.float32)
    ref = jax_compile_to_jit(_pure_functions(ray_tpu, jnp))(
        jnp.asarray(x), jnp.asarray(w))
    port = compile_to_jit(_pure_functions(ray_tpu_torch, torch))(
        torch.from_numpy(x), torch.from_numpy(w))
    assert len(ref) == len(port) == 2
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=JIT_TOL,
                                   atol=JIT_TOL)


def _flagship_split(rt, fns):
    """The tiny flagship's forward as DAG nodes: the embedding, one node
    a block, the head; ``fns`` holds the package's three functions."""
    embed, block, head = (rt.remote(f) for f in fns)
    dag_mod = importlib.import_module(f"{rt.__name__}.dag")
    with dag_mod.InputNode(0) as params, dag_mod.InputNode(1) as tokens:
        x = embed.bind(params, tokens)
        for i in range(TINY["n_layers"]):
            x = block.bind(params, x, i)
        return head.bind(params, x)


def _port_flagship_fns(cfg):
    from ray_tpu_torch.models import transformer as pt
    from ray_tpu_torch.ops.flash_attention import flash_attention

    def attn(q, k, v, causal=True):
        return flash_attention(q, k, v, causal=causal)

    def embed(params, tokens):
        return params["embed"][tokens].to(cfg.dtype)

    def block(params, x, i):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :].expand(x.shape[:2])
        return pt.apply_blocks(params["blocks"][i:i + 1], x, positions,
                               cfg, attn)

    def head(params, x):
        x = pt.rms_norm(x, params["final_norm"])
        return (x @ params["unembed"].to(cfg.dtype)).float()

    return embed, block, head


def _jax_flagship_fns(cfg):
    import jax.numpy as jnp
    jt = importlib.import_module("ray_tpu.models.transformer")
    from ray_tpu.ops.flash_attention import flash_attention

    def attn(q, k, v, causal=True):
        return flash_attention(q, k, v, causal=causal)

    def embed(params, tokens):
        return params["embed"].astype(cfg.dtype)[tokens]

    def block(params, x, i):
        positions = jnp.broadcast_to(
            jnp.arange(x.shape[1], dtype=jnp.int32)[None, :], x.shape[:2])
        return jt._block_forward(params["blocks"][i], x, positions, cfg,
                                 attn_fn=attn)

    def head(params, x):
        x = jt.rms_norm(x, params["final_norm"])
        return (x @ params["unembed"].astype(cfg.dtype)).astype(jnp.float32)

    return embed, block, head


def test_flagship_split_into_nodes_matches_forward_and_jax():
    import jax
    import jax.numpy as jnp
    import ray_tpu
    from ray_tpu.dag import compile_to_jit as jax_compile_to_jit
    from ray_tpu_torch.models import TransformerConfig, params_from_jax
    from ray_tpu_torch.models.transformer import forward

    jt = importlib.import_module("ray_tpu.models.transformer")
    jcfg = jt.TransformerConfig(**TINY, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray,
                        jt.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.RandomState(1).randint(0, 256, (1, 128)).astype(
        np.int32)
    pcfg = TransformerConfig(**TINY, dtype=torch.float32)
    params = params_from_jax(tree, device="cpu")
    ptok = torch.from_numpy(tokens)

    fn = compile_to_jit(_flagship_split(ray_tpu_torch,
                                        _port_flagship_fns(pcfg)))
    with torch.no_grad():
        port = fn(params, ptok)
        direct = forward(params, ptok, pcfg)
    assert port.shape == (1, 128, 256) and port.dtype == torch.float32
    assert torch.equal(port, direct)

    jparams = jax.tree.map(jnp.asarray, tree)
    ref = jax_compile_to_jit(_flagship_split(ray_tpu, _jax_flagship_fns(jcfg)))(
        jparams, jnp.asarray(tokens))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _accel_dag_scenario(rt, accel):
    """A CPU actor scales the input; an accelerator actor sums it."""
    @rt.remote
    class Prep:
        def scale(self, x):
            return x * 3

    @rt.remote(**{accel: 1})
    class Accel:
        def total(self, x):
            return float(x.sum())

    p, a = Prep.remote(), Accel.remote()
    with importlib.import_module(f"{rt.__name__}.dag").InputNode() as inp:
        dag = a.total.bind(p.scale.bind(inp))
    compiled = dag.experimental_compile()
    xs = np.arange(1000, dtype=np.float64)
    answers = [rt.get(compiled.execute(xs + i), timeout=60)
               for i in range(3)]
    compiled.teardown()
    return compiled.is_fast, answers


def test_accelerator_stage_is_fast_in_both_packages():
    import ray_tpu

    outs = []
    for rt, accel in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        rt.init(num_cpus=4, max_process_workers=1, **{accel: 8})
        try:
            outs.append(_accel_dag_scenario(rt, accel))
        finally:
            rt.shutdown()
    ref, port = outs
    assert port == ref
    assert port[0] is True
    assert port[1] == [float(3 * (np.arange(1000) + i).sum())
                       for i in range(3)]


@pytest.mark.cuda
def test_compile_to_jit_flagship_launches_flash_on_the_card():
    """On the card, the composed split forward launches the flash forward
    once a block and equals the direct forward bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.models.transformer import forward

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = TransformerConfig(**TINY, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, 256, (2, 128), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    fn = compile_to_jit(_flagship_split(ray_tpu_torch,
                                        _port_flagship_fns(cfg)))
    with torch.no_grad():
        before = fa.launches
        port = fn(params, tokens)
        launched = fa.launches - before
        direct = forward(params, tokens, cfg)
    assert launched == TINY["n_layers"]
    assert torch.equal(port, direct)


@pytest.mark.cuda
def test_cuda_tensor_crosses_a_compiled_channel():
    """A GPU stage's CUDA result crosses the compiled DAG's channel as
    serialized bytes and is rebuilt on the card for the downstream GPU
    stage (both on driver threads), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ray_tpu_torch.init(num_cpus=2, max_process_workers=1)
    try:
        @ray_tpu_torch.remote(num_gpus=0.5)
        class Producer:
            def make(self, seed):
                g = torch.Generator("cuda").manual_seed(seed)
                return torch.randn(1024, 257, device="cuda", generator=g)

        @ray_tpu_torch.remote(num_gpus=0.5)
        class Consumer:
            def take(self, x):
                return x.device.type, x.dtype, tuple(x.shape), x.cpu()

        p, c = Producer.remote(), Consumer.remote()
        with InputNode() as inp:
            dag = c.take.bind(p.make.bind(inp))
        compiled = dag.experimental_compile()
        assert compiled.is_fast
        for seed in (0, 1):
            dev, dtype, shape, host = ray_tpu_torch.get(
                compiled.execute(seed), timeout=60)
            g = torch.Generator("cuda").manual_seed(seed)
            want = torch.randn(1024, 257, device="cuda", generator=g).cpu()
            assert (dev, dtype, shape) == ("cuda", torch.float32, (1024, 257))
            assert torch.equal(host, want)
        compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
