"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with `ctypes` (no PyTorch headers: a build takes
seconds).  Libraries go to ``build/kernels/`` at the repository root, named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  A build writes to a temporary file and renames
it, so concurrent processes never load a half-written library.  ``ptxas``
reports each kernel's registers and spills (``-Xptxas -v``);
`ptxas_report` reads that report.

Nothing here runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # source name -> seconds nvcc took
ptxas_log: Dict[Path, str] = {}        # source path -> what ptxas printed


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def library_path(source: str, csrc: Path = CSRC) -> Path:
    src = Path(csrc) / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<source>`` (``csrc/`` of this package by default)
    unless a library of the same content exists; return the library's
    path."""
    src = Path(csrc) / source
    out = library_path(source, csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
        ptxas_log[src] = proc.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[source] = time.perf_counter() - t0
    return out


def ptxas_report(source: str, csrc: Path = CSRC) -> List[dict]:
    """Registers, stack and spill bytes of each kernel of ``source``, from
    ptxas's report of its build in this process ([] if it was not built
    here)."""
    rows: List[dict] = []
    for line in ptxas_log.get(Path(csrc) / source, "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry[1]
            tmpl = re.search(
                r"\d([a-z][a-z_]*_kernel)I(f|13__nv_bfloat16)Li(\d+)E", name)
            if tmpl:
                kind = "f32" if tmpl[2] == "f" else "bf16"
                name = f"{tmpl[1]}<{kind}, {tmpl[3]}>"
            rows.append({"kernel": name})
        elif rows:
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                rows[-1].update(stack=int(spill[1]),
                                spill_stores=int(spill[2]),
                                spill_loads=int(spill[3]))
            if regs:
                rows[-1]["registers"] = int(regs[1])
    return rows


def build_all(sources: Iterable[str]) -> None:
    """Compile several sources at once, one ``nvcc`` process each."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        for fut in [pool.submit(build, s) for s in todo]:
            fut.result()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib
