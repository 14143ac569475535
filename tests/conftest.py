"""Test configuration: force an 8-device CPU mesh.

Tests run on a virtual 8-device CPU backend, so sharding logic is exercised
without accelerator hardware: the backend can be switched after ``jax`` is
imported as long as no arrays have been created yet. Tests that need a GPU
take the ``gpu`` fixture below and skip here.

x64 is enabled so float64 parity tests against the numpy oracle are exact.
"""
import os
import sys

# Make repo root importable regardless of pytest rootdir config.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Smoke tier (`pytest -m smoke`, <5 min): goldens, one config per engine
# family, kernel/gradient parity, one sharding equality — the fast
# high-signal subset for inner-loop verification. The full (~25 min) suite
# remains the default and runs at round end.
# ---------------------------------------------------------------------------

_SMOKE_MODULES = {
    "test_oracle",            # closed-form + property goldens
    "test_external_goldens",  # published Yang CME absolute anchors
    "test_likelihood",        # core engine vs oracle (DNA/protein, +G +I)
    "test_sharding",          # 8-device mesh equality + psum grads
    "test_gradients",         # jax.grad vs finite differences
    "test_facades",           # reference-API facades
}

_SMOKE_TESTS = {
    # XLA walk parity against the f64 oracle, and walk-variant agreement
    ("test_pruning_xla", "test_xla_walk_matches_oracle"),
    ("test_pruning_xla", "test_walk_variants_value_and_grad_agree"),
    # one config per engine family
    ("test_codon", "test_gy94_logl_matches_oracle"),
    ("test_morphology", "test_lewis_correction_hand_computed_binary"),
    ("test_freerate", "test_freerate_matches_oracle_weighted_mixture"),
    ("test_mixtures", "test_kappa_mixture_matches_golden"),
    ("test_profile_mixtures", "test_profile_mixture_matches_oracle"),
    ("test_clock", "test_calibrated_dating_recovers_absolute_ages"),
    ("test_partition", "test_partitioned_equals_sum_of_engines"),
    # optimization basics
    ("test_optimize", "test_transform_roundtrip"),
    ("test_optimize", "test_fit_improves_and_reaches_optimum_neighborhood"),
    # platform-bug regression + one config per newer subsystem
    ("test_eigh_robustness", "test_sequential_eigh_matches_unbatched"),
    ("test_stacked_partition", "test_stacked_matches_general"),
    ("test_regroup", "test_tse_regrouped_matches_level_grid"),
    ("test_precision_guard", "test_f32_contractions_are_highest_precision"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        base = item.name.split("[")[0]
        if mod in _SMOKE_MODULES or (mod, base) in _SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)



@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is present. Decided here, at run time, so
    every pytest-xdist worker collects the same tests. This process stays on
    the CPU backend; a test that takes the fixture runs its card work in a
    child process."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True, timeout=60
    ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (on the card: "
                    "python -m pytest tests -m gpu)")
