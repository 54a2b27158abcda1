"""The port's pip/venv runtime environments (per-node cached builds):
the single-node cases of ``tests/test_pip_env.py`` on ``ray_tpu_torch``.
Offline-friendly: each test installs a tiny LOCAL source package with
``--no-index``, so no network is involved; the mechanism (venv build
under the temporary directory's ``rtpt_venvs``, cache key, dedicated
tagged workers, failure propagation, the refusal of a GPU demand) is
exactly the real path; its remote-raylet case runs on the port's
``Cluster``.
"""

import os
import shutil

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import pip_env
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def ray_start_regular():
    """The reference fixture's runtime on the port: 4 CPUs, 8 GPUs of
    resource (no card is needed for work that demands none), 2 process
    workers."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()



def _make_local_pkg(tmp_path, name: str, value: int) -> str:
    pkg = tmp_path / name
    pkg.mkdir()
    (pkg / "setup.py").write_text(
        "from setuptools import setup\n"
        f"setup(name={name!r}, version='1.0', py_modules=[{name!r}])\n")
    (pkg / f"{name}.py").write_text(f"VALUE = {value}\n")
    return str(pkg)


def _pip_spec(pkg_dir: str) -> dict:
    return {"packages": [pkg_dir],
            "pip_install_options": ["--no-index",
                                    "--no-build-isolation"]}


@pytest.fixture
def cleanup_envs():
    keys = []
    yield keys
    for key in keys:
        shutil.rmtree(os.path.join(pip_env.venv_root(), key),
                      ignore_errors=True)


def test_pip_env_task_and_cache(ray_start_regular, tmp_path,
                                cleanup_envs):
    """A task runs with a package the driver doesn't have; the second
    use reuses the cached venv (exactly one build)."""
    pkg_dir = _make_local_pkg(tmp_path, "rtpt_testpkg_a", 123)
    spec = _pip_spec(pkg_dir)
    cleanup_envs.append(pip_env.env_key(spec))

    with pytest.raises(ImportError):
        import rtpt_testpkg_a  # noqa: F401

    @ray_tpu_torch.remote
    def use_pkg():
        import rtpt_testpkg_a
        return rtpt_testpkg_a.VALUE

    ref = use_pkg.options(runtime_env={"pip": spec}).remote()
    assert ray_tpu_torch.get(ref, timeout=120) == 123

    # second use: cache hit — the build ledger stays at one line
    ref2 = use_pkg.options(runtime_env={"pip": spec}).remote()
    assert ray_tpu_torch.get(ref2, timeout=120) == 123
    builds = os.path.join(pip_env.venv_root(), pip_env.env_key(spec),
                          ".builds")
    assert len(open(builds).read().splitlines()) == 1


def test_pip_env_actor(ray_start_regular, tmp_path, cleanup_envs):
    pkg_dir = _make_local_pkg(tmp_path, "rtpt_testpkg_b", 7)
    spec = _pip_spec(pkg_dir)
    cleanup_envs.append(pip_env.env_key(spec))

    @ray_tpu_torch.remote
    class Uses:
        def __init__(self):
            import rtpt_testpkg_b
            self.v = rtpt_testpkg_b.VALUE

        def get(self):
            return self.v

    a = Uses.options(runtime_env={"pip": spec}).remote()
    assert ray_tpu_torch.get(a.get.remote(), timeout=120) == 7


def test_pip_env_build_failure_fails_task(ray_start_regular,
                                          cleanup_envs):
    spec = {"packages": ["definitely-not-a-package-xyz"],
            "pip_install_options": ["--no-index"]}
    cleanup_envs.append(pip_env.env_key(spec))

    @ray_tpu_torch.remote
    def f():
        return 1

    ref = f.options(runtime_env={"pip": spec}).remote()
    with pytest.raises(Exception, match="pip"):
        ray_tpu_torch.get(ref, timeout=120)


def test_pip_env_rejects_gpu_demand(ray_start_regular, tmp_path):
    pkg_dir = _make_local_pkg(tmp_path, "rtpt_testpkg_d", 1)

    @ray_tpu_torch.remote(num_gpus=1)
    def f():
        return 1

    ref = f.options(runtime_env={"pip": _pip_spec(pkg_dir)}).remote()
    with pytest.raises(Exception, match="GPU"):
        ray_tpu_torch.get(ref, timeout=60)


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_pip_env_on_remote_raylet(ray_start_cluster, tmp_path,
                                  cleanup_envs):
    """The raylet process builds its node's venvs (a cache per node, as
    in the reference architecture)."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"R": 2}, remote=True)
    pkg_dir = _make_local_pkg(tmp_path, "rtpt_testpkg_c", 55)
    spec = _pip_spec(pkg_dir)
    cleanup_envs.append(pip_env.env_key(spec))

    @ray_tpu_torch.remote(resources={"R": 1})
    def use_pkg():
        import rtpt_testpkg_c
        return rtpt_testpkg_c.VALUE

    ref = use_pkg.options(runtime_env={"pip": spec}).remote()
    assert ray_tpu_torch.get(ref, timeout=180) == 55
