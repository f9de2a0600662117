"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, the compile-cache placement, and a guard against the
retired Mosaic kernel path coming back."""

import os
import re
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 360, 480


def _run(args, env_update, cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_update)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    """Under JAX_PLATFORMS=cpu, in the repo or copied alone into an empty
    directory: non-zero exit and no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_ingest():
    cs.phase_ingest()


def test_phase_single():
    cs.phase_single(H, W)


def test_phase_batched():
    cs.phase_batched(4, H, W, steps=2)


def test_phase_camera():
    cs.phase_camera(H, W)


def test_phase_corpus():
    cs.phase_corpus(((H, W), (352, 480)), per_shape=4, batch_size=4)


def test_phase_serving():
    cs.phase_serving(H, W, 2)


def test_phase_four():
    """Both meshes on four of the eight virtual CPU devices; the tiny
    frames take the row-sharded body with the route threshold at 0 MP."""
    cs.phase_four(jax.devices()[:4], 4, H, W, 64, 96, spatial_route_mp=0.0,
                  check_memory=False)


def test_phases_leave_pil_and_matplotlib_unloaded():
    code = ("import sys, chip_smoke as cs; cs.phase_ingest(); "
            "import photohive_dsp_tpu.serving, photohive_dsp_tpu.report; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'PIL', 'matplotlib'}))")
    out = _run(["-c", code], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("case", ["env_dir", "cpu", "unset"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the cache is
    <checkout>/.jax_cache, salted by the host CPU only for CPU runs."""
    env = {"cpu": {"JAX_PLATFORMS": "cpu"},
           "unset": {},
           "env_dir": {"JAX_PLATFORMS": "cpu",
                       "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}}[case]
    code = ("import jax, photohive_dsp_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = _run(["-c", code], env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    root = os.path.join(REPO, ".jax_cache")
    if case == "env_dir":
        assert got == str(tmp_path)
    elif case == "cpu":
        assert os.path.dirname(got) == root
        assert re.fullmatch(r"cpu_[0-9a-f]{12}", os.path.basename(got))
    else:
        assert got == root


_RETIRED_KNOBS = ("PHOTOHIVE_NO_PALLAS", "PHOTOHIVE_PALETTE_KERNEL",
                  "PHOTOHIVE_POLAR_LOCAL", "PHOTOHIVE_SHARP_PALLAS",
                  "PHOTOHIVE_FFT_PALLAS", "PHOTOHIVE_U8_KERNELS",
                  "PHOTOHIVE_SUMS_I8", "PHOTOHIVE_SUMS_FLUSH_PX")
_FORBIDDEN = [re.compile(p) for p in (
    r"pallas(\.|\s+import\s+)[t]pu|pl[t]pu",
    r"default_backend\(\)",
    r"[\(\[{]\s*[\"'](cpu|gpu|[t]pu|cuda|rocm|METAL)[\"']\s*,",
    "|".join(_RETIRED_KNOBS))]


@pytest.mark.parametrize("scope", ["photohive_dsp_tpu", "bench.py", "tools"])
def test_no_retired_kernel_path(scope):
    """No Mosaic-flavoured Pallas import, no routing on backend-name
    lists and none of the retired kernel knobs."""
    root = os.path.join(REPO, scope)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py")]
    assert files
    hits = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if any(p.search(line) for p in _FORBIDDEN):
                    hits.append(f"{os.path.relpath(path, REPO)}:{n}: "
                                f"{line.strip()}")
    assert not hits, hits
