"""Config / option mnemonics parity tests (ref RtConfig, Runtime.cpp:37-149)."""

import pytest

import sparsex_jax as spx
from sparsex_jax.config import Config
from sparsex_jax.errors import SparsexError


def test_defaults_match_reference():
    cfg = Config.instance()
    assert cfg.nr_threads == 1
    # Default heuristic is the device execution-cost model; the reference's
    # "ratio"/"cost" heuristics remain selectable for behavioral parity.
    assert cfg.heuristic == "device"
    assert cfg.dia_min_fill == pytest.approx(0.01)
    assert cfg.xform == "all"
    assert cfg.sampling == "portion"
    assert cfg.nr_samples == 48
    assert cfg.sampling_portion == pytest.approx(0.01)
    assert cfg.window_size == 0
    assert cfg.symmetric is False
    assert cfg.split_blocks is True
    assert cfg.one_dim_blocks is False
    assert cfg.min_unit_size == 4
    assert cfg.max_unit_size == 255
    assert cfg.min_coverage == pytest.approx(0.1)


def test_option_set_mnemonics():
    spx.option_set("spx.preproc.xform", "h,v,br2")
    assert Config.instance().xform == "h,v,br2"
    spx.option_set("spx.rt.nr_threads", "4")
    assert Config.instance().nr_threads == 4
    spx.option_set("spx.matrix.symmetric", "true")
    assert Config.instance().symmetric is True


def test_invalid_option_raises():
    with pytest.raises(SparsexError):
        spx.option_set("spx.bogus.option", "1")
    with pytest.raises(SparsexError):
        spx.option_set("spx.preproc.heuristic", "fastest")


def test_env_overrides():
    cfg = Config.instance()
    cfg.load_from_env({
        "NUM_THREADS": "3",
        "XFORM_CONF": "h,d",
        "SAMPLING": "none",
        "SYMMETRIC": "1",
    })
    assert cfg.nr_threads == 3
    assert cfg.xform == "h,d"
    assert cfg.sampling == "none"
    assert cfg.symmetric is True


@pytest.mark.parametrize("key", ["spx.jax.use_pallas", "spx.jax.sb_pages",
                                 "spx.jax.min_fused_nnz"])
def test_removed_kernel_knobs_rejected(key):
    """The knobs that chose the removed Pallas kernels are unknown options."""
    with pytest.raises(SparsexError):
        spx.option_set(key, "1")
