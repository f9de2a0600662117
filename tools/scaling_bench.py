"""Scaling-efficiency measurements for BASELINE configs #4/#5.

The reference has no multi-device story at all (single-threaded C except
FFTW threads); these configs exist only for the JAX build.  This tool is
CPU-only: every JAX process it starts runs with JAX_PLATFORMS=cpu (virtual
devices or coordinated CPU processes), so it never opens a GPU.  It
measures sharding overheads and partition balance, plus the written
methodology that transfers to real multi-GPU hosts:

  ``curve``   — data-axis scaling curve on 1/2/4/8 *virtual* CPU devices.
                All virtual devices share this host's physical cores, so
                wall-clock cannot speed up with N; what the curve measures
                is the *overhead* of sharding: with a fixed total batch,
                perfect data-parallelism keeps wall time flat as the batch
                is split N ways.  T(N)/T(1)-1 is the sharding overhead
                (partition + dispatch + any inserted collectives).
  ``hlo``     — counts collective ops in the compiled data-parallel
                executable.  The data axis is embarrassingly parallel, so
                the expected count is ZERO: on real hardware no
                interconnect traffic means per-device throughput is
                independent of N.
  ``corpus``  — BASELINE config #4 at reduced scale: N synthetic images
                through the resumable ``process_corpus`` driver on the
                8-virtual-device mesh (end-to-end: PNG decode, bucketing,
                padding, sharded execution, JSONL + watermark output).
  ``hosts``   — config #5 logic-level: 2-host partition disjointness /
                coverage and the load-balance (straggler) term that
                bounds multi-host efficiency.

Methodology for >=85% efficiency at >=2 hosts (the BASELINE.json north
star), in terms measurable on real hardware:

    eff(N_hosts) = T(1 host, W) / (N * T(N hosts, W))
                 = 1 / (1 + c + s)

  where c = collective/communication fraction and s = straggler fraction.
  * c == 0 for the report workload: hosts share NO state — each host owns
    every num_hosts-th key of the sorted corpus (utils/io.py), chips
    within a host shard the batch axis, and the `hlo` mode verifies the
    executable contains no collectives.  (Spatially-sharded large images
    do psum/ppermute/all_to_all, but only across the GPUs of ONE host —
    NVLink, never the network.)
  * s = (max_host_work - mean_host_work) / mean_host_work over the key
    partition.  The `hosts` mode measures it for a synthetic mixed-res
    corpus with randomly-assigned shapes; round-robin partitioning keeps
    it at the sampling-noise level O(1/sqrt(images_per_host)) — well
    under the 15% budget for >=1k images.

Usage:
    python tools/scaling_bench.py curve|hlo|corpus|hosts|all [--n 2000]
Run it from the repo root; it re-execs itself with the right XLA flags.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Fixed total workload for the curve: identical work at every N.
CURVE_BATCH = 16
CURVE_H, CURVE_W = 384, 512


def _subenv(ndev: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={ndev}")
    return env


def _run_child(code: str, ndev: int, timeout: float = 600) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_subenv(ndev), timeout=timeout,
                         cwd=REPO)
    if out.returncode != 0:
        raise RuntimeError(f"child failed rc={out.returncode}:\n"
                           f"{out.stderr[-2000:]}")
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    if not lines:
        raise RuntimeError(
            f"child rc=0 but printed no JSON line:\nstdout: "
            f"{out.stdout[-1000:]}\nstderr: {out.stderr[-1000:]}")
    return json.loads(lines[-1])


_CHILD_PRELUDE = """
import json, time
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
import sys; sys.path.insert(0, {repo!r})
from photohive_dsp_tpu import ReportConfig
from photohive_dsp_tpu.models.batch import BatchRunner
from photohive_dsp_tpu.parallel.mesh import make_mesh
"""


def run_curve(ns=(1, 2, 4, 8)) -> list:
    """Fixed-total-work wall time vs number of data-parallel devices."""
    results = []
    for n in ns:
        code = _CHILD_PRELUDE.format(repo=REPO) + f"""
cfg = ReportConfig()
mesh = make_mesh(data={n}, spatial=1) if {n} > 1 else None
runner = BatchRunner(cfg, mesh=mesh)
rng = np.random.default_rng(0)
img = rng.integers(0, 256, ({CURVE_BATCH}, {CURVE_H}, {CURVE_W}, 3),
                   dtype=np.uint8)
out = runner.run_u8(img); np.asarray(out.blur_bins)   # compile
reps, best = 3, float('inf')
for _ in range(reps):
    t0 = time.perf_counter()
    out = runner.run_u8(img); np.asarray(out.blur_bins)
    best = min(best, time.perf_counter() - t0)
print(json.dumps(dict(ndev={n}, wall_s=round(best, 4))))
"""
        r = _run_child(code, n)
        results.append(r)
        print(f"  ndev={r['ndev']}: {r['wall_s'] * 1e3:.0f} ms "
              f"(fixed {CURVE_BATCH}x{CURVE_H}x{CURVE_W} batch)")
    t1 = results[0]["wall_s"]
    ncores = os.cpu_count() or 1
    for r in results:
        r["speedup"] = round(t1 / r["wall_s"], 3)
        # The methodology metric: fixed total work on shared cores means
        # ideal sharding keeps wall time at worst flat, so any time ABOVE
        # T(1) is sharding overhead.  (Speedup > 1 just means the 1-device
        # program didn't saturate the cores.)
        r["overhead_frac"] = round(max(0.0, r["wall_s"] / t1 - 1.0), 4)
        print(f"  ndev={r['ndev']}: speedup {r['speedup']:.2f}x, sharding "
              f"overhead {r['overhead_frac'] * 100:.1f}% "
              f"({ncores} shared physical cores)")
    return results


def run_hlo() -> dict:
    """Count collectives in the compiled data-parallel executable."""
    code = _CHILD_PRELUDE.format(repo=REPO) + f"""
from photohive_dsp_tpu.parallel.sharding import data_parallel_report_u8
cfg = ReportConfig()
mesh = make_mesh(data=8, spatial=1)
fn, tables = data_parallel_report_u8({CURVE_H}, {CURVE_W}, cfg, mesh, False)
rng = np.random.default_rng(0)
u8 = jax.numpy.asarray(rng.integers(0, 256, (8, {CURVE_H}, {CURVE_W}, 3),
                                    dtype=np.uint8))
boxes = jax.numpy.zeros((8, 10, 4), jax.numpy.int32)
valid = jax.numpy.zeros((8, 10), bool)
hlo = fn.lower(u8, boxes, valid, tables).compile().as_text()
colls = ['all-reduce', 'all-gather', 'all-to-all', 'collective-permute',
         'reduce-scatter']
counts = {{c: hlo.count(c) for c in colls}}
print(json.dumps(dict(collective_counts=counts,
                      total=sum(counts.values()))))
"""
    r = _run_child(code, 8)
    print(f"  collectives in 8-way dp executable: {r['total']} "
        f"({r['collective_counts']})")
    return r


def make_corpus(root: str, n: int, seed: int = 0) -> list:
    """n small synthetic PNGs (mixed resolutions, compressible content)."""
    from PIL import Image
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    shapes = [(350, 350), (360, 480), (384, 512)]
    paths = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        # gradient + rectangles: realistic-ish structure, tiny PNGs
        y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
        x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
        img = np.stack([y + 0 * x, 0 * y + x, (y + x) / 2], -1)
        for _ in range(3):
            r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
            img[r0:r0 + 40, c0:c0 + 40] = rng.integers(0, 256, 3)
        p = os.path.join(root, f"img_{i:05d}.png")
        Image.fromarray(img.astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def run_corpus(n: int) -> dict:
    """Config #4 at reduced scale: n images through process_corpus on the
    8-virtual-device data mesh, end to end."""
    import tempfile

    workdir = tempfile.mkdtemp(prefix="ph_scaling_")
    corpus_dir = os.path.join(workdir, "corpus")
    t0 = time.perf_counter()
    paths = make_corpus(corpus_dir, n)
    gen_s = time.perf_counter() - t0
    print(f"  generated {n} PNGs in {gen_s:.0f}s -> {corpus_dir}")

    code = _CHILD_PRELUDE.format(repo=REPO) + f"""
import glob
from photohive_dsp_tpu.utils.io import process_corpus
cfg = ReportConfig()
mesh = make_mesh(data=8, spatial=1)
paths = sorted(glob.glob({corpus_dir!r} + '/*.png'))
t0 = time.perf_counter()
done = process_corpus(paths, {workdir!r} + '/out', cfg=cfg, mesh=mesh,
                      batch_size=32)
dt = time.perf_counter() - t0
import json as _json
nlines = sum(1 for _ in open({workdir!r} + '/out/reports.0.jsonl'))
mp = sum({{(350, 350): 0.1225, (360, 480): 0.1728,
           (384, 512): 0.196608}}[s] for s in
         [(350, 350), (360, 480), (384, 512)]) / 3 * done
print(_json.dumps(dict(images=done, jsonl_lines=nlines,
                       wall_s=round(dt, 1),
                       img_per_s=round(done / dt, 2),
                       mp_per_s=round(mp / dt, 2))))
"""
    r = _run_child(code, 8, timeout=3600)
    r["gen_s"] = round(gen_s, 1)
    r["workdir"] = workdir
    print(f"  corpus: {r['images']} images in {r['wall_s']}s "
          f"({r['img_per_s']} img/s, {r['mp_per_s']} MP/s), "
          f"{r['jsonl_lines']} JSONL lines")
    assert r["jsonl_lines"] == r["images"] == n
    return r


def run_hosts(n: int = 1200) -> dict:
    """Config #5 logic level: 2-host key partition disjointness/coverage
    and the measured straggler fraction of the hash partition."""
    import numpy as np

    shapes = [(350, 350), (360, 480), (384, 512), (720, 1080), (1080, 1920)]
    rng = np.random.default_rng(7)
    # random shape per image: a realistic mixed-res corpus, so the
    # straggler term is genuine sampling noise, not zero by construction
    shape_of = {f"img_{i:05d}.png": shapes[rng.integers(len(shapes))]
                for i in range(n)}
    paths = sorted(shape_of)
    parts = [[p for i, p in enumerate(paths) if i % 2 == h]
             for h in (0, 1)]
    assert not set(parts[0]) & set(parts[1])
    assert set(parts[0]) | set(parts[1]) == set(paths)
    work = [sum(shape_of[p][0] * shape_of[p][1] for p in part)
            for part in parts]
    mean = sum(work) / 2
    straggler = max(work) / mean - 1.0
    eff = 1.0 / (1.0 + straggler)  # c == 0 (no cross-host collectives)
    r = dict(n_images=n, host_pixels=work,
             straggler_frac=round(straggler, 5),
             projected_2host_eff=round(eff, 4))
    print(f"  2-host partition: disjoint+complete; straggler "
          f"{straggler * 100:.2f}% -> projected efficiency {eff * 100:.1f}%"
          f" (>=85% target)")
    return r


def run_hosts_e2e(n: int) -> dict:
    """Config #5 at reduced scale: TWO OS processes (distinct JAX
    runtimes joined via the distributed coordinator) stream disjoint
    halves of one corpus through process_corpus concurrently."""
    import socket
    import tempfile
    import textwrap

    workdir = tempfile.mkdtemp(prefix="ph_hosts_")
    corpus_dir = os.path.join(workdir, "corpus")
    make_corpus(corpus_dir, n)
    out_dir = os.path.join(workdir, "out")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = textwrap.dedent(f"""
        import glob, sys, time
        import jax
        jax.config.update('jax_platforms', 'cpu')
        sys.path.insert(0, {REPO!r})
        pid = int(sys.argv[1])
        from photohive_dsp_tpu.parallel.mesh import initialize_distributed
        initialize_distributed('localhost:{port}', 2, pid)
        from photohive_dsp_tpu import ReportConfig
        from photohive_dsp_tpu.utils.io import process_corpus
        paths = sorted(glob.glob({corpus_dir!r} + '/*.png'))
        t0 = time.perf_counter()
        done = process_corpus(paths, {out_dir!r}, cfg=ReportConfig(),
                              batch_size=32, num_hosts=2, host_id=pid)
        print('HOST_DONE', pid, done, round(time.perf_counter() - t0, 1),
              flush=True)
    """)
    wpath = os.path.join(workdir, "worker.py")
    with open(wpath, "w") as f:
        f.write(worker)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, wpath, str(pid)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=3600) for p in procs]
    finally:
        for p in procs:  # don't leak the sibling if one hangs
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"host worker failed:\n{err[-2000:]}")
    import json as _json
    keys = []
    for pid in (0, 1):
        with open(os.path.join(out_dir, f"reports.{pid}.jsonl")) as f:
            keys.append({_json.loads(l)["key"] for l in f})
    assert not keys[0] & keys[1] and len(keys[0] | keys[1]) == n
    r = dict(n_images=n, wall_s=round(wall, 1),
             img_per_s=round(n / wall, 2),
             per_host=[len(k) for k in keys], workdir=workdir)
    print(f"  2-process e2e: {n} images in {wall:.0f}s "
          f"({r['img_per_s']} img/s aggregate), shards {r['per_host']}, "
          f"disjoint+complete")
    return r


def run_eff2proc(n: int) -> dict:
    """MEASURED 2-process scaling efficiency (not the byte-balance
    projection): same corpus, same host, resources held proportional.

    T1   = one process pinned to 2 cores streaming ALL n images.
    T2   = two coordinator-joined processes pinned to DISJOINT 2-core
           sets (cores 0-1 / 2-3), each streaming its num_hosts=2 half.
    eff  = T1 / (2 * T2).  With zero cross-host state (no collectives —
    see `hlo` mode) the loss terms are the straggler fraction of the
    round-robin key partition plus per-process fixed costs (startup,
    first-dispatch); both shrink with corpus size.

    Core pinning is what makes the division honest on one physical host:
    without it the single process would use all 4 cores and eff would
    measure core contention, not scaling.  Requires >= 4 cores."""
    import tempfile
    import textwrap

    ncores = os.cpu_count() or 1
    if ncores < 4:
        raise RuntimeError(f"need >=4 cores for pinned 2-proc eff, "
                           f"have {ncores}")
    workdir = tempfile.mkdtemp(prefix="ph_eff2_")
    corpus_dir = os.path.join(workdir, "corpus")
    make_corpus(corpus_dir, n)

    worker = textwrap.dedent(f"""
        import glob, sys, time
        import jax
        jax.config.update('jax_platforms', 'cpu')
        sys.path.insert(0, {REPO!r})
        num_hosts = int(sys.argv[1]); pid = int(sys.argv[2])
        out_dir = sys.argv[3]
        if num_hosts > 1:
            from photohive_dsp_tpu.parallel.mesh import (
                initialize_distributed)
            initialize_distributed(sys.argv[4], num_hosts, pid)
        from photohive_dsp_tpu import ReportConfig
        from photohive_dsp_tpu.utils.io import process_corpus
        paths = sorted(glob.glob({corpus_dir!r} + '/*.png'))
        t0 = time.perf_counter()
        done = process_corpus(paths, out_dir, cfg=ReportConfig(),
                              batch_size=32, num_hosts=num_hosts,
                              host_id=pid, decode_workers=2)
        print('HOST_DONE', pid, done,
              round(time.perf_counter() - t0, 1), flush=True)
    """)
    wpath = os.path.join(workdir, "worker.py")
    with open(wpath, "w") as f:
        f.write(worker)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def timed(cmds) -> float:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        try:
            outs = [p.communicate(timeout=7200) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{err[-2000:]}")
        return time.perf_counter() - t0

    # warm the persistent compile cache so neither arm pays first-compile
    warm_dir = os.path.join(workdir, "warm")
    timed([["taskset", "-c", "0,1", sys.executable, wpath, "1", "0",
            warm_dir]])

    out1 = os.path.join(workdir, "out1")
    t1 = timed([["taskset", "-c", "0,1", sys.executable, wpath, "1", "0",
                 out1]])
    print(f"  1-proc (cores 0-1): {n} images in {t1:.0f}s")

    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out2 = os.path.join(workdir, "out2")
    coord = f"localhost:{port}"
    t2 = timed([["taskset", "-c", cores, sys.executable, wpath, "2",
                 str(pid), out2, coord]
                for pid, cores in ((0, "0,1"), (1, "2,3"))])
    print(f"  2-proc (cores 0-1 / 2-3): {n} images in {t2:.0f}s")

    import json as _json
    keys = []
    for pid in (0, 1):
        with open(os.path.join(out2, f"reports.{pid}.jsonl")) as f:
            keys.append({_json.loads(l)["key"] for l in f})
    assert not keys[0] & keys[1] and len(keys[0] | keys[1]) == n
    eff = t1 / (2.0 * t2)
    r = dict(n_images=n, t1_wall_s=round(t1, 1), t2_wall_s=round(t2, 1),
             measured_2proc_eff=round(eff, 4),
             cores_per_proc=2, workdir=workdir)
    print(f"  measured 2-proc efficiency: T1/(2*T2) = {t1:.0f}/(2*{t2:.0f})"
          f" = {eff * 100:.1f}%  (>=85% target)")
    return r


def run_hosts4(n: int = 400) -> dict:
    """FOUR coordinator-joined processes (1 pinned core each) stream
    disjoint quarters of one corpus — refutes the round-2 assumption
    that this environment caps out at 2 jax.distributed processes, and
    demonstrates the num_hosts partition at a less-trivial fan-out.
    Verifies disjointness + coverage; wall skew across workers is the
    measured straggler term at this scale."""
    import tempfile
    import textwrap

    ncores = os.cpu_count() or 1
    nproc = min(4, ncores)
    workdir = tempfile.mkdtemp(prefix="ph_h4_")
    corpus_dir = os.path.join(workdir, "corpus")
    make_corpus(corpus_dir, n)
    worker = textwrap.dedent(f"""
        import glob, sys, time
        import jax
        jax.config.update('jax_platforms', 'cpu')
        sys.path.insert(0, {REPO!r})
        pid = int(sys.argv[1])
        from photohive_dsp_tpu.parallel.mesh import initialize_distributed
        initialize_distributed(sys.argv[2], {nproc}, pid)
        from photohive_dsp_tpu import ReportConfig
        from photohive_dsp_tpu.utils.io import process_corpus
        paths = sorted(glob.glob({corpus_dir!r} + '/*.png'))
        t0 = time.perf_counter()
        done = process_corpus(paths, {workdir!r} + '/out',
                              cfg=ReportConfig(), batch_size=16,
                              num_hosts={nproc}, host_id=pid,
                              decode_workers=1)
        print('HOST_DONE', pid, done,
              round(time.perf_counter() - t0, 1), flush=True)
    """)
    wpath = os.path.join(workdir, "worker.py")
    with open(wpath, "w") as f:
        f.write(worker)
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        ["taskset", "-c", str(p), sys.executable, wpath, str(p),
         f"localhost:{port}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for p in range(nproc)]
    try:
        outs = [p.communicate(timeout=3600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    walls = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{err[-2000:]}")
        walls.append(float(out.split()[-1]))
    import json as _json
    keys = []
    for pid in range(nproc):
        with open(os.path.join(workdir, "out",
                               f"reports.{pid}.jsonl")) as f:
            keys.append({_json.loads(l)["key"] for l in f})
    assert len(set().union(*keys)) == n
    assert sum(len(k) for k in keys) == n
    straggler = max(walls) / (sum(walls) / nproc) - 1.0
    r = dict(n_images=n, nproc=nproc, wall_s=round(wall, 1),
             per_worker_wall_s=walls,
             straggler_frac=round(straggler, 4), workdir=workdir)
    print(f"  {nproc}-process e2e: {n} images in {wall:.0f}s, per-worker "
          f"{walls}, disjoint+complete, straggler {straggler*100:.1f}%")
    return r


def run_route4k() -> dict:
    """Replicate-vs-row-shard comparison at 4K (the 8 MP routing policy,
    models/batch.SPATIAL_ROUTE_MP) on the 8-virtual-device mesh.

    Same total work both ways: 8 images of 2160x3840.
      * replicate: flat data mesh — one whole image per device;
      * rowshard:  data=4 x spatial=2 — each image's rows split 2-way.
    CAVEAT (methodology): virtual devices share this host's cores, so
    compute cannot speed up with sharding and the collectives run as
    memcpy — this measures each route's *structural overhead* (padding,
    halo/all_to_all bookkeeping, per-shard fixed costs) at equal FLOPs.
    The real crossover (where HBM capacity or per-chip latency forces
    row-sharding) needs >= 2 physical chips; on one chip the policy is
    moot — BatchRunner only routes spatially when the mesh HAS a spatial
    axis.  What this pins: the spatial route's overhead factor vs pure
    dp at the routing threshold, i.e. the price the policy pays when it
    fires."""
    code = _CHILD_PRELUDE.format(repo=REPO) + """
H, W, B = 2160, 3840, 8
cfg = ReportConfig()
rng = np.random.default_rng(0)
img = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
results = {}
for name, mesh_args, route_mp in (("replicate", dict(data=8, spatial=1),
                                   1e9),
                                  ("rowshard", dict(data=4, spatial=2),
                                   0.0)):
    mesh = make_mesh(**mesh_args)
    runner = BatchRunner(cfg, mesh=mesh, spatial_route_mp=route_mp)
    assert runner.routes_spatially(H, W) == (name == "rowshard")
    out = runner.run_u8(img); np.asarray(out.blur_bins)     # compile
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.run_u8(img); np.asarray(out.blur_bins)
        best = min(best, time.perf_counter() - t0)
    results[name] = round(best, 3)
results["overhead_factor"] = round(results["rowshard"]
                                   / results["replicate"], 3)
print(json.dumps(results))
"""
    r = _run_child(code, 8, timeout=1800)
    print(f"  4K x8 fixed work: replicate {r['replicate']}s vs rowshard "
          f"{r['rowshard']}s -> spatial-route overhead factor "
          f"{r['overhead_factor']}x (virtual devices: equal-FLOPs "
          f"structural overhead, not a chip crossover)")
    return r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["curve", "hlo", "corpus", "hosts",
                                     "hosts2e2e", "eff2proc", "route4k",
                                     "hosts4", "all"])
    ap.add_argument("--n", type=int, default=2000,
                    help="corpus size for `corpus` mode")
    args = ap.parse_args()

    results = {}
    if args.mode in ("curve", "all"):
        print("== data-axis scaling curve (fixed total work) ==")
        results["curve"] = run_curve()
    if args.mode in ("hlo", "all"):
        print("== collectives in the dp executable ==")
        results["hlo"] = run_hlo()
    if args.mode in ("hosts", "all"):
        print("== 2-host partition / straggler ==")
        results["hosts"] = run_hosts()
    if args.mode in ("hosts2e2e",):
        print(f"== config #5 reduced-scale 2-process run ({args.n}) ==")
        results["hosts2e2e"] = run_hosts_e2e(args.n)
    if args.mode in ("eff2proc",):
        print(f"== measured 2-process efficiency, pinned cores "
              f"({args.n}) ==")
        results["eff2proc"] = run_eff2proc(args.n)
    if args.mode in ("route4k",):
        print("== 4K replicate vs row-shard (8 MP routing policy) ==")
        results["route4k"] = run_route4k()
    if args.mode in ("hosts4",):
        print("== 4-process coordinated corpus ==")
        results["hosts4"] = run_hosts4(args.n if args.n != 2000 else 400)
    if args.mode in ("corpus", "all"):
        print(f"== config #4 reduced-scale corpus ({args.n} images) ==")
        results["corpus"] = run_corpus(args.n)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
