"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded
with ctypes. The build runs at first use, into ``_build/`` next
to this file (listed in .gitignore), keyed by a hash of the sources and
flags, with nvcc's report beside it. A failed build or load raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo"]

_lib = None
_lib_lock = threading.Lock()       # one build and load, whichever thread
_count_lock = threading.Lock()
_tls = threading.local()
# launches by (lane tag, kernel module), for launches made inside lane()
lane_launches: dict = {}
build_seconds = 0.0      # wall time of the last build (0 = cached)
# nvcc's output of the build in use (-Xptxas -v report), kept beside the
# library and read back when the library is cached
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    global build_seconds, build_log
    sources = sorted(_CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")) + sorted(_CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD / f"libgtkernels-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=str(_BUILD)) as td:
        t0 = time.perf_counter()
        objs = [Path(td) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(sources, objs)]
        logs, failed = [], []
        try:
            for src, proc in zip(sources, procs):
                text, _ = proc.communicate(timeout=900)
                logs.append(f"== {src.name}\n{text}")
                if proc.returncode != 0:
                    failed.append(src.name)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = Path(td) / "libgtkernels.so"
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True,
                timeout=300)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        build_seconds = time.perf_counter() - t0
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               f"{build_log}")
        log.write_text(build_log)
        os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call; threads that ask
    meanwhile wait for that build)."""
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _load()
    return _lib


def _load() -> None:
    global _lib
    so = _build()
    L = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cip = ctypes.POINTER(ci)
    # int gt_greedy_full(pool, stride, desc[6], order, ctr, out, slot_gens,
    #                    conf, N, stream); gt_xdrop_full the same with
    #                    desc[5]
    for fn in (L.gt_greedy_full, L.gt_xdrop_full):
        fn.argtypes = [vp, ctypes.c_longlong, ctypes.POINTER(vp), vp, vp,
                       vp, vp, cip, ci, vp]
        fn.restype = ci
    # int gt_greedy_full_occupancy(conf, out[3]), gt_xdrop_full_occupancy
    for fn in (L.gt_greedy_full_occupancy, L.gt_xdrop_full_occupancy):
        fn.argtypes = [cip, cip]
        fn.restype = ci
    # int gt_greedy_chunk(P, row, h, hsize, mm, valid, d_lane, done, died,
    #                     paused, best, urem, vrem, kbase, rowbase, N, W,
    #                     D, GENS, cut_depth, mmp128, mad, match_score,
    #                     difference_score, hist_cap, stream)
    L.gt_greedy_chunk.argtypes = [vp] * 15 + [ci] * 10 + [vp]
    L.gt_greedy_chunk.restype = ci
    # int gt_greedy_resident(pool, stride, ustart, ulen, vstart, vlen, rev,
    #                        seedlen, order, ctr, best, died, route, chunks,
    #                        slot_gens, conf, N, stream)
    L.gt_greedy_resident.argtypes = [vp, ctypes.c_longlong] + [vp] * 13 + \
        [cip, ci, vp]
    L.gt_greedy_resident.restype = ci
    # int gt_greedy_resident_occupancy(wmax, out[3])
    L.gt_greedy_resident_occupancy.argtypes = [ci, cip]
    L.gt_greedy_resident_occupancy.restype = ci
    L.gt_cuda_error_string.argtypes = [ci]
    L.gt_cuda_error_string.restype = ctypes.c_char_p
    _lib = L


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib().gt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def call(fn: str, device, *args) -> None:
    """Launch the library's `fn` on `device`'s card with args and the
    calling thread's current stream of that card; raise on an error."""
    import torch
    with torch.cuda.device(device):
        err = getattr(lib(), fn)(*args, stream_ptr(device))
    check(err, fn)


def record_launch(mod_globals: dict, slot_gens: int = 0,
                  nbytes: int = 0) -> None:
    """Count one launch of a kernel wrapper (its module's `launches`, and
    `work` where it has one), and the lane's, under one lock: lanes on
    several threads lose no increment."""
    with _count_lock:
        mod_globals["launches"] += 1
        if "work" in mod_globals:
            mod_globals["work"]["slot_gens"] += int(slot_gens)
            mod_globals["work"]["bytes"] += int(nbytes)
        tag = getattr(_tls, "lane", None)
        if tag is not None:
            key = (tag, mod_globals["__name__"].rsplit(".", 1)[-1])
            lane_launches[key] = lane_launches.get(key, 0) + 1


@contextmanager
def lane(tag, device):
    """Run the body as lane `tag` on `device`: its launches are counted
    under the tag, and on a card the body runs with that card current and
    on a stream of its own, synchronised at the end."""
    import torch
    _tls.lane = tag
    try:
        if device.type != "cuda":
            yield
            return
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                yield
            stream.synchronize()
    finally:
        _tls.lane = None
