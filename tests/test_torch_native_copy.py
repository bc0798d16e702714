"""The port keeps its own copy of the host runtime's source and opens
nothing of the reference package at run time."""

import os
import pathlib
import subprocess
import sys

from sedef_tpu_torch.native import build

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "sedef_tpu_torch"


def test_native_source_equals_the_reference_packages():
    """While both copies exist they are the same bytes."""
    ref = REPO / "sedef_tpu" / "native" / "native.cc"
    assert build.NATIVE_SRC.read_bytes() == ref.read_bytes()


def test_build_sources_lie_inside_the_port():
    srcs = [build.NATIVE_SRC, *build.cuda_sources()]
    assert len(srcs) >= 4
    for src in srcs:
        assert src.is_file(), src
        assert PORT in src.resolve().parents, src
    names = {s.name for s in build.cuda_sources()}
    assert {"wavefront_fill.cu", "traceback_pack.cu",
            "wavefront_fill_variants.cu"} <= names
    for out in (build.NATIVE_SO, build.KERNELS_SO):
        assert PORT in out.resolve().parents, out


def test_port_opens_no_file_of_the_reference_package(tmp_path):
    """Importing the port, loading its native library and aligning a
    batch opens no path under ``sedef_tpu/`` (audit hook on ``open``)."""
    code = (
        "import sys, os\n"
        f"ref = {str(REPO / 'sedef_tpu') + os.sep!r}\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes)):\n"
        "        p = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if p.startswith(ref):\n"
        "            seen.append(p)\n"
        "sys.addaudithook(hook)\n"
        "import numpy as np\n"
        "from sedef_tpu_torch.native import build, lib\n"
        "from sedef_tpu_torch.ops import wavefront as wf\n"
        "import sedef_tpu_torch.devcal, sedef_tpu_torch.tools.kbench\n"
        "build.build_native()\n"
        "assert lib.has('align')\n"
        "al = wf.WavefrontAligner(device='cpu')\n"
        "q = np.array([0, 1, 2, 3] * 8, np.int8)\n"
        "assert al.align_batch([(q, q)]) == [[('M', 32)]]\n"
        "assert not seen, seen\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(m == 'sedef_tpu' or m.startswith('sedef_tpu.')"
        " for m in sys.modules)\n"
        "print('OWN_FILES_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OWN_FILES_OK" in r.stdout
