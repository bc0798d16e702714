"""Counterpart of ``sedef_tpu/native/build.py``.

Builds the port's two shared libraries into ``sedef_tpu_torch/_build/``:

* ``libsedef_native.so`` — the C++ host runtime, compiled with ``g++``
  from the package's own ``native/native.cc`` (a copy of the reference
  package's file, kept equal by a test while both exist);
* ``libsedef_kernels.so`` — the hand-written CUDA kernels of
  ``sedef_tpu_torch/csrc/*.cu``, compiled with ``nvcc`` for ``sm_90a``
  behind a plain C interface (bound with ``ctypes``; no PyTorch headers,
  so the build takes seconds): one ``nvcc -c`` per source, all started
  together, then one link.

Each output is rebuilt when it is missing or older than its sources, and
written through a temporary file and an atomic rename, so concurrent
processes never load a half-written library.

    python -m sedef_tpu_torch.native.build [--cuda]
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NATIVE_SRC = PKG / "native" / "native.cc"
CSRC = PKG / "csrc"
NATIVE_SO = BUILD_DIR / "libsedef_native.so"
KERNELS_SO = BUILD_DIR / "libsedef_kernels.so"


def _stale(out: pathlib.Path, srcs: list[pathlib.Path]) -> bool:
    if not out.exists():
        return True
    t = out.stat().st_mtime
    return any(s.stat().st_mtime > t for s in srcs)


def _compile(cmd: list[str], out: pathlib.Path, verbose: bool) -> float:
    """Run ``cmd`` with ``-o <tmp>`` appended, then rename onto ``out``.
    Returns the build seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    full = cmd + ["-o", str(tmp)]
    if verbose:
        print(" ".join(full), file=sys.stderr)
    t0 = time.perf_counter()
    r = subprocess.run(full, capture_output=True, text=True)
    if verbose or r.returncode:
        sys.stderr.write(r.stdout + r.stderr)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise subprocess.CalledProcessError(r.returncode, full, r.stdout,
                                            r.stderr)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_native(verbose: bool = False, force: bool = False
                 ) -> pathlib.Path:
    """The host runtime, built from ``native/native.cc``."""
    if not NATIVE_SRC.exists():
        raise FileNotFoundError(f"native source missing: {NATIVE_SRC}")
    if force or _stale(NATIVE_SO, [NATIVE_SRC]):
        _compile(["g++", "-std=c++17", "-O3", "-fPIC", "-shared",
                  "-march=native", "-fopenmp-simd", "-funroll-loops",
                  str(NATIVE_SRC)], NATIVE_SO, verbose)
    return NATIVE_SO


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise FileNotFoundError("nvcc not found (needed to build the CUDA "
                            "kernels of sedef_tpu_torch/csrc)")


def cuda_sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def build_cuda(verbose: bool = False, force: bool = False,
               log: dict[str, str] | None = None) -> pathlib.Path:
    """The CUDA kernels: ``nvcc -gencode arch=compute_90a,code=sm_90a``,
    one compile per source in parallel, then one link.  ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory, spills per kernel) and
    echoes the compiler's output; ``log``, where given, receives each
    source's compiler output by its stem."""
    srcs = cuda_sources()
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if not (force or _stale(KERNELS_SO, deps)):
        return KERNELS_SO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    objs = [BUILD_DIR / f".{s.stem}.{os.getpid()}.o" for s in srcs]
    try:
        procs = []
        for src, obj in zip(srcs, objs):
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            if verbose:
                print(" ".join(cmd), file=sys.stderr)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = None
        for src, (cmd, proc) in zip(srcs, procs):
            out, err = proc.communicate()
            if log is not None:
                log[src.stem] = out + err
            if verbose or proc.returncode:
                sys.stderr.write(out + err)
            if proc.returncode and failed is None:
                failed = subprocess.CalledProcessError(proc.returncode, cmd,
                                                       out, err)
        if failed is not None:
            raise failed
        _compile([nvcc, "-shared", *[str(o) for o in objs]], KERNELS_SO,
                 verbose)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return KERNELS_SO


if __name__ == "__main__":
    print("built", build_native(verbose=True, force=True))
    if "--cuda" in sys.argv:
        print("built", build_cuda(verbose=True, force=True))
