"""Persistent compile cache: where it lives and how it is keyed.

``JAX_COMPILATION_CACHE_DIR`` wins outright (the library sets no other
directory); otherwise the cache lives in the checkout, under
``.jax_cache/<host fingerprint>/``.  XLA:CPU AOT executables bake in the
compile host's machine features, so the default directory is keyed by a host
fingerprint — an entry planted under a foreign host's key must never be
visible to this host.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from psa_tpu.utils import compile_cache as cc

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, env_cache_dir=None) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_COMPILATION_CACHE_DIR', 'PSA_TPU_NO_COMPILE_CACHE')}
    env['JAX_PLATFORMS'] = 'cpu'
    if env_cache_dir is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = str(env_cache_dir)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_fingerprint_stable_and_short():
    fp1, fp2 = cc.host_fingerprint(), cc.host_fingerprint()
    assert fp1 == fp2
    assert len(fp1) == 16 and all(c in "0123456789abcdef" for c in fp1)


def test_fingerprint_tracks_cpu_features(monkeypatch):
    """A host with different CPU feature flags (e.g. AMX present vs absent)
    must map to a different cache directory — that IS the miss."""
    native = cc.host_fingerprint()
    monkeypatch.setattr(cc, "_cpu_feature_flags",
                        lambda: "fpu amx_tile amx_int8 avx512f")
    foreign = cc.host_fingerprint()
    assert foreign != native


def test_foreign_entry_is_a_miss(tmp_path, monkeypatch):
    """Plant an executable under a foreign host's key: resolving the cache
    on this host must select a different directory that does not contain
    the foreign entry."""
    monkeypatch.setattr(cc, "DEFAULT_BASE", tmp_path)
    monkeypatch.setattr(cc, "_cpu_feature_flags", lambda: "amx-having-host")
    foreign_dir = Path(cc.resolve_cache_dir(None)[0])
    foreign_dir.mkdir()
    (foreign_dir / "xla_executable_deadbeef").write_bytes(b"\x90" * 16)
    monkeypatch.undo()
    monkeypatch.setattr(cc, "DEFAULT_BASE", tmp_path)

    resolved, ours = cc.resolve_cache_dir(None)
    assert ours and Path(resolved) == tmp_path / cc.host_fingerprint()
    assert Path(resolved) != foreign_dir
    assert not os.path.exists(os.path.join(resolved,
                                           "xla_executable_deadbeef"))


def test_enabled_dir_is_fingerprinted():
    """The live session's cache dir (enabled at psa_tpu import) must end
    with this host's fingerprint unless the user set the location or
    disabled the cache."""
    active = cc._enabled_dir
    if active is None:
        pytest.skip("cache disabled in this environment")
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        pytest.skip("user-specified cache dir wins, not fingerprinted")
    assert os.path.basename(active) == cc.host_fingerprint()


def test_default_dir_lies_in_the_checkout():
    resolved, ours = cc.resolve_cache_dir(None)
    assert ours
    assert Path(resolved).parent == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_configured_dir_is_left_alone():
    assert cc.resolve_cache_dir("/some/where") == ("/some/where", False)


def test_env_var_is_the_only_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the library sets no directory of
    its own, and compiled programs persist there."""
    out = _run(
        "import jax, psa_tpu, os\n"
        "from psa_tpu.utils import compile_cache as cc\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jax.numpy.ones(7)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(cc._enabled_dir)\n", env_cache_dir=tmp_path)
    configured, enabled = out.splitlines()[-2:]
    assert configured == enabled == str(tmp_path)
    assert any(tmp_path.iterdir()), "nothing was cached in the env var's dir"


def test_unset_env_var_uses_checkout_default():
    out = _run("import jax, psa_tpu\n"
               "print(jax.config.jax_compilation_cache_dir)\n")
    assert Path(out.splitlines()[-1]) == (REPO / ".jax_cache"
                                         / cc.host_fingerprint())
