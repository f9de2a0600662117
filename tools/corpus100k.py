"""Config #5 at full scale: 100k-image streaming corpus on 2 coordinated
processes.

CPU-only: every JAX process this tool starts runs with JAX_PLATFORMS=cpu
pinned to its own cores, so it never opens a GPU (two JAX processes on one
card would each try to reserve most of its memory).

Produces, in order:
  1. a 100k-PNG synthetic mixed-res corpus (reuses scaling_bench.make_corpus
     shapes; ~400 MB),
  2. T1: one process pinned to cores 0-1 streaming ALL 100k images,
  3. T2: two coordinator-joined processes pinned to cores 0-1 / 2-3,
     each streaming its num_hosts=2 half — RSS of both workers sampled
     every 5 s into rss.jsonl,
  4. eff = T1 / (2*T2)  (the measured 2-process scaling efficiency; at
     this scale the ~12 s per-process fixed startup is <1% — the
     remaining loss is same-socket DRAM/LLC contention),
  5. a kill-and-resume demonstration: worker 0 of a THIRD run is killed
     (SIGKILL) mid-stream and restarted; the merged outputs must still
     be exactly-once (100k unique keys, no duplicates) — at 100k scale,
     not just the unit-test scale of test_corpus.py.

Writes a JSON summary to <workdir>/results.json and prints it.

Usage: python tools/corpus100k.py [n] [existing_corpus_dir]
       PHOTOHIVE_100K_SKIP_T1=1 to skip the T1 arm (eff unmeasured)
       PHOTOHIVE_100K_SKIP_RESUME=1 to skip the kill+resume arm

NOTE: run this ALONE on the host — pytest or compile jobs sharing the
4 cores slow the pinned workers several-fold and corrupt the T1/T2
efficiency comparison.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _worker_script(corpus_dir: str) -> str:
    return textwrap.dedent(f"""
        import glob, sys, time
        import jax
        jax.config.update('jax_platforms', 'cpu')
        sys.path.insert(0, {REPO!r})
        num_hosts = int(sys.argv[1]); pid = int(sys.argv[2])
        out_dir = sys.argv[3]
        if num_hosts > 1 and len(sys.argv) > 4:
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


def _rss_sampler(procs, out_path, stop):
    with open(out_path, "a") as f:
        while not stop.is_set():
            row = {"t": round(time.time(), 1), "rss_mb": []}
            for p in procs:
                try:
                    with open(f"/proc/{p.pid}/statm") as s:
                        rss_pages = int(s.read().split()[1])
                    row["rss_mb"].append(round(rss_pages * 4096 / 1e6, 1))
                except (OSError, ValueError):
                    row["rss_mb"].append(None)
            f.write(json.dumps(row) + "\n")
            f.flush()
            stop.wait(5.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100000
    from scaling_bench import make_corpus

    workdir = tempfile.mkdtemp(prefix="ph_100k_")
    print(f"workdir {workdir}", flush=True)
    if len(sys.argv) > 2:
        corpus_dir = sys.argv[2]
        import glob as _glob
        found = len(_glob.glob(os.path.join(corpus_dir, "*.png")))
        assert found == n, f"existing corpus has {found} != {n}"
        print(f"reusing corpus {corpus_dir}", flush=True)
    else:
        corpus_dir = os.path.join(workdir, "corpus")
        t0 = time.perf_counter()
        make_corpus(corpus_dir, n)
        print(f"generated {n} PNGs in {time.perf_counter() - t0:.0f}s",
              flush=True)

    wpath = os.path.join(workdir, "worker.py")
    with open(wpath, "w") as f:
        f.write(_worker_script(corpus_dir))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def spawn(cores, args):
        return subprocess.Popen(
            ["taskset", "-c", cores, sys.executable, wpath, *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def wait_all(procs, timeout=14400):
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker rc={p.returncode}:\n"
                                   f"{err[-3000:]}")
            outs.append(out)
        return outs

    results = {"n": n, "workdir": workdir}

    # warm the persistent compile cache (tiny slice, separate out dir)
    print("warming compile cache...", flush=True)
    warm_env = dict(env)
    t0 = time.perf_counter()
    p = subprocess.Popen(
        ["taskset", "-c", "0,1", sys.executable, "-c", textwrap.dedent(
            f"""
            import glob, sys
            import jax; jax.config.update('jax_platforms', 'cpu')
            sys.path.insert(0, {REPO!r})
            from photohive_dsp_tpu import ReportConfig
            from photohive_dsp_tpu.utils.io import process_corpus
            paths = sorted(glob.glob({corpus_dir!r} + '/*.png'))[:96]
            process_corpus(paths, {workdir!r} + '/warm',
                           cfg=ReportConfig(), batch_size=32)
            """)], env=warm_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    p.communicate(timeout=600)
    results["warm_s"] = round(time.perf_counter() - t0, 1)
    print(f"warm {results['warm_s']}s", flush=True)

    # --- T2: the 100k 2-process run, RSS sampled
    rss_path = os.path.join(workdir, "rss.jsonl")
    out2 = os.path.join(workdir, "out2")
    coord = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    procs = [spawn(cores, ["2", str(pid), out2, coord])
             for pid, cores in ((0, "0,1"), (1, "2,3"))]
    stop = threading.Event()
    sampler = threading.Thread(target=_rss_sampler,
                               args=(procs, rss_path, stop), daemon=True)
    sampler.start()
    try:
        wait_all(procs)
    finally:
        stop.set()
        sampler.join(timeout=10)
    t2 = time.perf_counter() - t0
    results["t2_wall_s"] = round(t2, 1)
    print(f"T2 (2 procs): {n} images in {t2:.0f}s", flush=True)

    # verify exactly-once + coverage
    keys = []
    nlines = 0
    for pid in (0, 1):
        with open(os.path.join(out2, f"reports.{pid}.jsonl")) as f:
            ks = [json.loads(ln)["key"] for ln in f]
        nlines += len(ks)
        keys.append(set(ks))
        assert len(ks) == len(keys[-1]), f"duplicate keys in shard {pid}"
    assert not keys[0] & keys[1], "shards overlap"
    assert len(keys[0] | keys[1]) == n, \
        f"coverage {len(keys[0] | keys[1])} != {n}"
    results["jsonl_lines"] = nlines
    rss = [r for r in map(json.loads, open(rss_path))
           if all(v is not None for v in r["rss_mb"])]
    peaks = [max(r["rss_mb"][i] for r in rss) for i in (0, 1)]
    results["rss_peak_mb"] = peaks
    results["rss_samples"] = len(rss)
    print(f"exactly-once OK: {nlines} unique lines; RSS peaks {peaks} MB",
          flush=True)

    # --- T1 (optional): one process, all images
    if not os.environ.get("PHOTOHIVE_100K_SKIP_T1"):
        out1 = os.path.join(workdir, "out1")
        t0 = time.perf_counter()
        wait_all([spawn("0,1", ["1", "0", out1])])
        t1 = time.perf_counter() - t0
        results["t1_wall_s"] = round(t1, 1)
        results["measured_2proc_eff"] = round(t1 / (2 * t2), 4)
        print(f"T1 (1 proc): {t1:.0f}s -> eff = {t1:.0f}/(2*{t2:.0f}) = "
              f"{t1 / (2 * t2) * 100:.1f}%", flush=True)

    # --- kill-and-resume at scale: fresh out dir, kill worker 0 mid-run,
    # restart it, verify exactly-once on the merged result
    if os.environ.get("PHOTOHIVE_100K_SKIP_RESUME"):
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps(results), flush=True)
        return
    out3 = os.path.join(workdir, "out3")
    coord = None  # uncoordinated halves: resume must not depend on init
    procs = [spawn(cores, ["2", str(pid), out3])
             for pid, cores in ((0, "0,1"), (1, "2,3"))]
    kill_after = max(60.0, t2 * 0.25)
    time.sleep(kill_after)
    if procs[0].poll() is not None:
        # worker already finished: a SIGKILL now would make the
        # "resume" vacuous — report that honestly instead of recording
        # a resilience check that never ran
        for p in procs:
            p.communicate(timeout=14400)
        results["kill_resume_exactly_once"] = "SKIPPED (run finished " \
            "before kill point; use a larger n)"
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps(results), flush=True)
        return
    os.kill(procs[0].pid, signal.SIGKILL)
    procs[0].wait()
    n_at_kill = sum(1 for _ in open(
        os.path.join(out3, "reports.0.jsonl"))) \
        if os.path.exists(os.path.join(out3, "reports.0.jsonl")) else 0
    assert n_at_kill < n // 2, \
        f"worker 0 already emitted its full shard ({n_at_kill}) at the " \
        "kill point — the resume check would be vacuous"
    print(f"killed worker 0 after {kill_after:.0f}s at {n_at_kill} "
          "lines; restarting", flush=True)
    t0 = time.perf_counter()
    procs[0] = spawn("0,1", ["2", "0", out3])
    wait_all(procs)
    results["resume_restart_s"] = round(time.perf_counter() - t0, 1)
    keys3 = []
    for pid in (0, 1):
        with open(os.path.join(out3, f"reports.{pid}.jsonl")) as f:
            ks = [json.loads(ln)["key"] for ln in f]
        assert len(ks) == len(set(ks)), \
            f"resume produced duplicates in shard {pid}"
        keys3.append(set(ks))
    assert len(keys3[0] | keys3[1]) == n
    results["kill_resume_exactly_once"] = True
    print("kill+resume exactly-once OK", flush=True)

    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
