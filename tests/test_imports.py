"""The compute path needs only JAX and NumPy: ``import psa_tpu``, loading a
dump, the calculator and the iSED dump writer run with matplotlib, PIL and
yaml unavailable (plotting and YAML configs import them on first use)."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCK = '''
import sys
class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('matplotlib', 'yaml', 'PIL'):
            raise ImportError(f"{name} blocked")
        return None
sys.meta_path.insert(0, _Blocked())
'''

COMPUTE = '''
import numpy as np, tempfile, os
import psa_tpu
from psa_tpu import SEDCalculator, TrajectoryLoader, TrajectoryWriter
from psa_tpu.models import make_chain_trajectory
traj = make_chain_trajectory(n_cells=8, n_frames=16, dt_ps=0.05)
calc = SEDCalculator(traj, nx=8, ny=1, nz=1)
k_mags, k_vecs = calc.get_k_path('x', bz_coverage=0.5, n_k=5)
assert np.isfinite(calc.calculate(k_mags, k_vecs).sed).all()
with tempfile.TemporaryDirectory() as tmp:
    dump = os.path.join(tmp, 'r.dump')
    calc.ised('x', k_target=0.6, w_target=5.0, char_len_k_path=2.5,
              nk_on_path=5, n_recon_frames=3, dump_filepath=dump)
    assert TrajectoryLoader(dump, dt=0.05).load().n_frames == 3
blocked = [m for m in ('matplotlib', 'yaml', 'PIL') if m in sys.modules]
assert not blocked, blocked
try:
    psa_tpu.SEDPlotter
except ImportError:
    print("plotting needs matplotlib: OK")
'''


def test_compute_path_without_plotting_or_yaml():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, '-c', BLOCK + COMPUTE], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "plotting needs matplotlib: OK" in proc.stdout


def test_plotting_names_still_import():
    import psa_tpu
    from psa_tpu import SEDPlotter, apply_style
    assert SEDPlotter is psa_tpu.visualization.SEDPlotter
    assert callable(apply_style)
