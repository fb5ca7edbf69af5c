"""chip_smoke.py: refuses to pass without a GPU; its phases rehearsed on the
CPU at a tiny size (the card runs them at 10⁵ atoms × 10⁴ frames)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, 'chip_smoke.py', *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('args', [(), ('--mesh', '4')])
def test_fails_without_a_gpu(args):
    proc = _run_smoke(REPO, *args)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert 'needs an NVIDIA GPU' in proc.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / 'chip_smoke.py', tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_scale_phase_rehearsal():
    # above one atom block, so the compensated projection runs
    chip_smoke.scale_phase(n_atoms=5000, n_frames=16)


def test_physics_phase_rehearsal():
    chip_smoke.physics_phase(n_cells=4, n_frames=256)


def test_mesh_phase_rehearsal():
    chip_smoke.mesh_phase(4, n_atoms=600, n_frames=32)


def test_a_failed_check_fails_the_phase(capsys):
    with pytest.raises(RuntimeError, match="phase demo failed"):
        with chip_smoke.Phase('demo') as ph:
            ph.check('too_large', 2e-6, 1e-6, 'parity')
    assert '"ok": false' in capsys.readouterr().out
