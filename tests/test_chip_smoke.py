"""The on-card smoke script's phases, at tiny sizes on the CPU mesh.

On the card each phase runs at its real size (``python chip_smoke.py``);
here the same functions check their plumbing and their comparison with
scipy, and the script's refusal to run without a GPU.
"""

import jax
import pytest

import chip_smoke


def test_refuses_without_gpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_unsym", dict(n=1 << 12)),
    ("phase_classes", dict(n=1 << 12)),
    ("phase_spmm", dict(n=1 << 11, k=8)),
    ("phase_hpcg_cg", dict(nx=10)),
    ("phase_sharded", dict(n=1 << 12, nx=8, ndev=4)),
], ids=["unsym", "classes", "spmm", "hpcg_cg", "sharded4"])
def test_phase_small(phase, kwargs):
    assert len(jax.devices()) >= 4
    out = getattr(chip_smoke, phase)(**kwargs)
    assert out


@pytest.fixture
def gpu_present():
    """Skip unless nvidia-smi sees a card (the test process itself stays
    on the CPU; the smoke script runs in a child that opens the card)."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        pytest.skip("no nvidia-smi: not a GPU machine")
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("nvidia-smi lists no GPU")


@pytest.mark.gpu
def test_smoke_script_on_gpu(gpu_present):
    """The whole smoke script on the card, in a child process."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, chip_smoke.__file__],
                       capture_output=True, text=True, env=env, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
