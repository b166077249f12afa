"""Building and binding the port's CUDA sources.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C entry
point. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/`` at the repository
root and loaded through ``ctypes``. A library is named after its source
and a hash of the source and the flags, so a build is reused while both
stay the same, and each source builds on its own.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# -fmad=false and no fast math: every f32 add, multiply and divide
# rounds as the plain torch versions' do (bit-comparable outputs)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``, else under the
    toolkit torch itself detects."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME")]
    from torch.utils.cpp_extension import CUDA_HOME
    homes.append(CUDA_HOME)
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the port's kernels are built from csrc/*.cu with "
                       "nvcc")


def library_path(source: Path) -> Path:
    """Where the build of ``source`` for the current flags lives; the
    hash covers the headers beside the sources (``csrc/*.cuh``) too."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(Path(source).read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile every source that has no build of the same source and
    flags yet, one ``nvcc`` per source, all started together; returns
    the shared libraries' paths in the order of ``sources``. Each
    compiler report (registers, shared memory, spills) is kept beside
    its library as ``.log``."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs, strict=True)
            if not lib.is_file()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, proc in procs:
        report, _ = proc.communicate()
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc exit {proc.returncode}\n"
                          f"{report}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def build_library(source: Path) -> Path:
    """:func:`build_libraries` for one source."""
    return build_libraries([source])[0]
