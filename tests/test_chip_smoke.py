"""``chip_smoke.py``: its phases at tiny sizes on the CPU, its refusal to run
without a GPU, and its last line. The card run itself is the ``gpu`` test.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "no card (CPU test)"
TINY = cs.Sizes(dna_taxa=8, dna_patterns=200, oracle_patterns=64,
                fit_steps=2, prot_taxa=6, prot_patterns=100, codon_taxa=5,
                codon_patterns=40, cli_taxa=6, cli_sites=60,
                server_fit_steps=2, four_fit_steps=2)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""
    return env


def _run(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args],
        capture_output=True, text=True, timeout=300, env=_cpu_env(),
        cwd=REPO,
    )


@pytest.fixture(scope="module")
def dna_phase():
    return cs.phase_dna(CARD, TINY, seed=0)


def test_refuses_cpu_backend():
    r = _run("chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "card:" not in r.stdout
    assert "needs a GPU" in r.stderr


def test_bench_refuses_cpu_backend():
    r = _run("bench.py")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs a GPU" in r.stderr


def test_last_line_format():
    dev = jax.devices()[0]
    out = json.loads(cs.last_line(dev, 4))
    assert out == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 4}}


def test_phase_dna(dna_phase):
    rec, e32, params = dna_phase
    assert rec["n_patterns"] == TINY.dna_patterns
    par = rec["parity"]
    assert par["rel_f32_vs_f64"] <= cs.F32_VS_F64
    assert par["rel_f64_vs_oracle"] <= cs.F64_VS_ORACLE
    assert par["grad_rel_f32_vs_f64"] <= cs.GRAD_RTOL
    assert rec["fit"]["steps"] == TINY.fit_steps
    assert rec["forward_kernels"]["total"] > 0
    assert set(rec["memory_analysis"]) == {"loglik", "gradient"}
    assert e32.dtype == np.float32
    json.dumps(rec)


def test_phase_server(dna_phase):
    rec, e32, params = dna_phase
    out = cs.phase_server(CARD, e32, params, rec["parity"]["loglik_f32"],
                          TINY)
    assert out["health"]["platform"] == "cpu"
    assert out["rel_loglik_vs_phase1"] <= 1e-12
    assert out["fit"]["steps"] == TINY.server_fit_steps


def test_phase_protein():
    rec = cs.phase_protein(CARD, TINY, seed=0)
    assert rec["n_patterns"] == TINY.prot_patterns
    assert rec["parity"]["rel_f64_vs_oracle"] <= cs.F64_VS_ORACLE


def test_phase_codon():
    rec = cs.phase_codon(CARD, TINY, seed=0)
    assert rec["n_patterns"] == TINY.codon_patterns
    assert rec["parity"]["rel_f64_vs_oracle"] <= cs.F64_VS_ORACLE


def test_phase_cli():
    rec = cs.phase_cli(CARD, TINY, seed=0)
    assert rec["rel_loglik_vs_engine"] <= 1e-10
    assert rec["fit_loglik"] >= rec["loglik"]


def test_phase_four_on_virtual_devices():
    devices = jax.devices()[:4]
    assert len(devices) == 4
    rec = cs.phase_four(CARD, TINY, seed=0, devices=devices)
    assert rec["n_devices"] == 4
    assert rec["parity"]["rel_loglik"] <= cs.SHARDED_VS_SINGLE


def test_eigh_exhibit_finite():
    rec = cs.eigh_exhibit(CARD)
    assert rec["batched_eigh_finite"]


def test_kernel_count_reads_hlo():
    x = jax.numpy.ones((8, 8), jax.numpy.float32)
    compiled = jax.jit(lambda a: jax.numpy.tanh(a @ a).sum()).lower(
        x).compile()
    counts = cs.kernel_count(compiled.as_text())
    assert counts["total"] >= 1
    assert "parameter" not in counts["by_opcode"]


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match="f32 vs f64"):
        cs.check(False, "f32 vs f64 logL", rel=1.0)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on the card, in a child process (this process
    stays on the CPU backend)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=1200,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
