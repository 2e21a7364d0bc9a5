"""chip_smoke.py's phases on the CPU at the tiny test sets.

The script itself refuses to run without a GPU; its phase functions take
their parameter sets and sizes as arguments, so every check it makes on
the card is exercised here at a small size.  The real-width reference
compare is the ``chip`` test at the bottom.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from zig_tfhe_jax import params as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def split_keys():
    sk, ck, _ = chip_smoke.keygen(P.TEST_TINY_SPLIT, 2, packing_key=False)
    return sk, ck


def test_reference_phase_tiny(capsys):
    chip_smoke.phase_reference(P.TEST_TINY, P.TEST_TINY_SPLIT, batch=8,
                               dot_shape=(64, 128, 64), s32_n=64)
    out = capsys.readouterr().out
    assert out.startswith("reference: exact, tolerance 0:")
    assert "split_ring==numpy (tiny_split N=2048" in out


@pytest.mark.parametrize("which", ["tiny", "tiny_split"])
def test_gates_phase(which, tiny_sk, tiny_ck, split_keys, capsys):
    sk, ck = (tiny_sk, tiny_ck) if which == "tiny" else split_keys
    res = chip_smoke.phase_gates(sk, ck, batch=32, iters=2)
    assert res["accuracy"] == 1.0
    assert res["steps"] == chip_smoke.scan_steps(ck)
    assert set(res["lowering"]) == {
        "cublas", "triton_fusions", "other_custom_calls", "unfused_dot",
        "loop_fusions", "input_fusions"}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"gates {which}: accuracy 1.0")
    assert lines[1].startswith(f"lowering {which} gate step: ")


@pytest.mark.parametrize("circuit", ["adder16", "mult16"])
def test_circuit_phase(circuit, tiny_sk, tiny_ck):
    if circuit == "adder16":
        assert chip_smoke.phase_adder(tiny_sk, tiny_ck) == 706
    else:
        got = chip_smoke.phase_bristol(tiny_sk, tiny_ck, width=16, seed=5)
        rng = np.random.default_rng(5)
        a = int(rng.integers(0, 1 << 62)) % (1 << 16)
        b = int(rng.integers(0, 1 << 62)) % (1 << 16)
        assert got == a * b


def test_four_phase_virtual_devices(tiny_sk, tiny_ck, split_keys, capsys):
    """The --four phase on 4 virtual CPU devices: every sharded leg is
    compared bit for bit with one device inside the phase."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four(tiny_sk, tiny_ck, *split_keys, per32=8, per64=8,
                          devices=jax.devices()[:4])
    out = capsys.readouterr().out
    assert out.startswith("four: ")
    assert out.count("bit-exact vs one card, accuracy 1.0") == 3


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_placement(env_set, monkeypatch):
    # the suite (tests/conftest.py) follows the same rule as the script
    assert jax.config.jax_compilation_cache_dir == chip_smoke.cache_dir()
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
        assert chip_smoke.cache_dir() == "/some/cache"
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert chip_smoke.cache_dir() == os.path.join(chip_smoke.REPO,
                                                      ".jax_cache")


@pytest.mark.chip
def test_reference_compare_real_width(gpu):
    chip_smoke.phase_reference(P.SECURITY_128_BIT, P.SECURITY_128_BIT_T64,
                               batch=64, dot_shape=(2048 * 4, 1024, 1024),
                               s32_n=1024)
