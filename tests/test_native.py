"""The native parser library is built from the committed source only: its
file name carries the hash of the source and flags it was built from."""
import pytest

from psa_tpu.io import native


def test_library_name_tracks_the_source(tmp_path):
    src = tmp_path / "fastparse.c"
    src.write_text("int f(void) { return 1; }\n")
    first = native.lib_path(src)
    src.write_text("int f(void) { return 2; }\n")
    second = native.lib_path(src)
    assert first != second
    assert first.name.startswith("libpsa_fastparse-") and first.suffix == ".so"
    assert native.lib_path(src) == second          # deterministic


def test_loaded_library_is_the_current_build():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C compiler on this host")
    assert lib._name == str(native.lib_path())
