"""True multi-process distributed test: two processes, one global mesh.

Exercises the actual multi-host runtime path (jax.distributed.initialize +
global mesh + make_array_from_process_local_data + cross-process reduction)
on CPU — the same code a multi-host accelerator cluster runs, with the
interconnect swapped for local gRPC. SURVEY.md §4.5 / §5.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "benchmarks", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pair(script, extra_args, env):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(i), "2", str(port), *extra_args],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            cwd=_REPO,
            text=True,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=280)
        results.append((p.returncode, out, err))
    return results


def _clean_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"         # never open the accelerator
    env["XLA_FLAGS"] = ""                # worker sets its own device count
    return env


def test_two_process_global_mesh_loglik():
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            cwd=_REPO,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=280)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(o["global_devices"] == 8 for o in outs)
    assert all(o["match"] for o in outs), outs
    # both processes observe the identical globally-reduced logL
    assert outs[0]["sharded_loglik"] == outs[1]["sharded_loglik"]


_FIT_WORKER = os.path.join(_REPO, "benchmarks", "multihost_fit_worker.py")


def test_two_process_fit_killed_and_resumed_bitexact(tmp_path):
    """A 2-process sharded fit, hard-killed mid-run, resumes from the
    process-0 checkpoint and lands bit-identical to an uninterrupted run
    (VERDICT r1 item 9: multi-host failure/recovery behavior)."""
    env = _clean_env()
    ckpt = str(tmp_path / "fit.ckpt.npz")

    # 1. uninterrupted 12-step run: the golden endpoint digest
    clean = _spawn_pair(_FIT_WORKER, ["clean", ckpt], env)
    for rc, out, err in clean:
        assert rc == 0, f"clean worker failed:\n{err[-2000:]}"
    clean_rows = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in clean]
    assert clean_rows[0]["digest"] == clean_rows[1]["digest"]

    # 2. same run, hard-killed (os._exit mid-step-loop) at step 7; the
    #    cadence-3 checkpoint written by process 0 at step 6 survives
    crashed = _spawn_pair(_FIT_WORKER, ["crash", ckpt], env)
    for rc, _, _ in crashed:
        assert rc == 137, f"crash worker exited {rc}, expected hard-kill 137"
    assert os.path.exists(ckpt), "no checkpoint survived the kill"
    import numpy as np
    with np.load(ckpt) as z:
        meta = json.loads(bytes(z["__pytree_meta__"].tobytes()).decode())
    assert meta["step"] == 6

    # 3. restart both processes from the checkpoint; endpoint must be
    #    bit-identical to the uninterrupted run
    resumed = _spawn_pair(_FIT_WORKER, ["resume", ckpt], env)
    for rc, out, err in resumed:
        assert rc == 0, f"resume worker failed:\n{err[-2000:]}"
    res_rows = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in resumed]
    assert res_rows[0]["digest"] == res_rows[1]["digest"]
    assert res_rows[0]["digest"] == clean_rows[0]["digest"], (
        "resumed trajectory diverged from the uninterrupted run"
    )
