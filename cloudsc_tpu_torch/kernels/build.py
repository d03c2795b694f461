"""Build and load the port's CUDA kernels.

`csrc/*.cu` compile with `nvcc` at first use into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: seconds to build,
not minutes). Each source compiles in its own `nvcc -c`, all started
together, and one `nvcc -shared` links the objects. The library goes to
`build/cloudsc_tpu_torch/<hash>/` under the repository root, keyed by a hash
of the sources and flags, so a rerun on the same checkout does not rebuild.
Flags: sm_90a, -O3, C++17, -fmad=false (no multiply-add contraction, so the
kernels agree with their plain versions to a few ulps; the probes write
their multiply-adds as explicit fmaf) and no fast math, plus K1's ring
geometry as -D macros (`cuda_cloudsc.RING`, or another geometry for a
sweep: `bench/ring_sweep.py`), K1's version as -D macros
(`cuda_cloudsc.KernelVersion`: the scheme version, the pack's form, the
skipped sections and the skip switches) and K3's ring geometry as -D macros
(`cuda_probes.COPY_RING`, read when the flags are made). The default build
holds every source but `ALONE`'s with the reference configuration on the
main path's form; another version builds K1's source alone into its own
directory at first use, and `csrc/foldo.cu` (the flux rows' kernel, which
no version changes) builds only alone, into its own at first use, so one
library serves it under every version. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "cloudsc_tpu_torch"
LIB_NAME = "libcloudsc_kernels.so"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_vp, _i, _ll, _d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
_STEP_ARGS = [_vp] * 6 + [_i] * 3 + [_vp]
# every C entry point of the library and its argument types (pointers and
# the stream as void*, 64-bit offsets as long long); each returns the
# launch's cudaError_t as an int
ENTRY_POINTS = {
    **{f"cloudsc_{body}_{t}": _STEP_ARGS
       for body in ("fused", "floor", "init") for t in ("f32", "f64")},
    # (int out[7]): K1's occupancy and geometry on the current device
    **{f"cloudsc_fused_occupancy_{t}": [_vp] for t in ("f32", "f64")},
    # K1 on a field dict read in place (the unfolded build's only): the
    # host arrays of row pointers and heights, plsm, ldcum, ktype, consts,
    # the three outputs, nlev, ncol, nrows, stream; and its occupancy
    **{f"cloudsc_fused_rows_{t}": [_vp] * 9 + [_i] * 3 + [_vp]
       for t in ("f32", "f64")},
    **{f"cloudsc_fused_rows_occupancy_{t}": [_vp] for t in ("f32", "f64")},
    # the ZDQS row of a field dict (the unfolded builds' only): the host
    # arrays of row pointers and heights, consts (in host memory), the row,
    # nlev, ncol, nrows, stream
    **{f"cloudsc_zdqs_rows_{t}": [_vp] * 4 + [_i] * 3 + [_vp]
       for t in ("f32", "f64")},
    "overlap_probe": [_vp] * 5 + [_i] * 7 + [_vp],
    "copy_probe": [_vp] * 4 + [_i, _i, _ll, _i, _ll, _ll, _i, _vp],
    # (int out[9]): K3's geometry and occupancy on the current device
    "copy_probe_geometry": [_vp],
    # the five input rows, their level strides, the output buffer, nlev,
    # ncol, the five constants (rounded to the type in the entry), stream
    **{f"cloudsc_foldo_{t}": [_vp] * 5 + [_ll] * 5 + [_vp, _i, _i]
       + [_d] * 5 + [_vp] for t in ("f32", "f64")},
}

# sources that build only alone, into a library of their own, and the entry
# points they hold, which the default library lacks
ALONE = {"foldo.cu": ("cloudsc_foldo_f32", "cloudsc_foldo_f64")}
# the entry points only the unfolded builds of K1 hold
# (`KernelVersion.fold_inputs` False): the Rows policy and zdqs_kernel read
# the fields
UNFOLDED_ONLY = tuple(n for n in ENTRY_POINTS
                      if n.startswith(("cloudsc_fused_rows_",
                                       "cloudsc_zdqs_rows_")))

# loaded libraries by (geometry, sources, scheme version); (None, None,
# None) is the default build
_libs: dict = {}
# what the default build (or its cache hit) reported: seconds, ptxas lines,
# per-kernel registers/spills
BUILD_INFO: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def nvcc_flags(ring=None, version=None) -> tuple:
    """NVCC_FLAGS, K1's ring geometry (a `cuda_cloudsc.RingGeometry`; None
    is `RING`) as the CLOUDSC_RING_<STAGES|BLOCK|MIN_BLOCKS> macros of
    csrc/cloudsc_fused.cu, K1's scheme version (a
    `cuda_cloudsc.KernelVersion`; None is the reference configuration on
    the main path's form) as the CLOUDSC_* macros of
    csrc/cloudsc_scheme.cuh, and K3's ring
    (`cuda_probes.COPY_RING`) as the COPY_RING_<STAGES|CHUNK|CTAS> macros
    of csrc/probes.cu."""
    from . import cuda_cloudsc, cuda_probes

    ring = cuda_cloudsc.RING if ring is None else ring
    version = cuda_cloudsc.DEFAULT_VERSION if version is None else version
    return NVCC_FLAGS + (f"-DCLOUDSC_RING_STAGES={ring.stages}",
                         f"-DCLOUDSC_RING_BLOCK={ring.block}",
                         f"-DCLOUDSC_RING_MIN_BLOCKS={ring.min_blocks}") \
        + version.macros() + cuda_probes.COPY_RING.macros()


def _sources(sources=None) -> list[Path]:
    """The .cu files to compile: all of csrc/ but `ALONE`'s, or
    `sources`."""
    return sorted(sources) if sources else \
        sorted(p for p in CSRC.glob("*.cu") if p.name not in ALONE)


def _version_sources(sources, version):
    """(sources, version) with the default scheme version as None, and K1's
    source alone for another version when no sources are named."""
    from .cuda_cloudsc import DEFAULT_VERSION

    if version == DEFAULT_VERSION:
        version = None
    if version is not None and not sources:
        sources = [CSRC / "cloudsc_fused.cu"]
    return sources, version


def source_hash(flags: tuple, sources=None) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources(sources) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


_TYPES = {"f": "f32", "d": "f64"}


def kernel_key(mangled: str) -> str:
    """A mangled kernel name -> its key: the innermost name without
    `_kernel`, then its template arguments, a float type as f32/f64 and an
    integer as its value: `fused_kernel<float>` and `fused_kernel<float,
    Pack>` (K1's Pack policy, a tag) -> 'fused_f32', `fused_kernel<double,
    Rows<double>>` (its Rows policy) -> 'fused_f64_rows',
    `floor_kernel<double>` -> 'floor_f64', `overlap_kernel<3, 8>` ->
    'overlap_3_8', `copy_kernel` -> 'copy'. Other names stay as they
    are."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group())
        pos += len(m.group())
        name = mangled[pos:pos + n]
        pos += n
    if name is None:
        return mangled
    parts = [name.removesuffix("_kernel")]
    if mangled.startswith("I", pos):
        args, rows = re.subn(r"NS_4RowsI[fd]EE", "", mangled[pos + 1:], 1)
        for tok in re.finditer(r"Li(-?\d+)E|([fd])(?=[ELIN])", args):
            parts.append(tok.group(1) if tok.group(1) is not None
                         else _TYPES[tok.group(2)])
            if args[tok.end():].startswith("EE"):
                break
        parts += ["rows"] * rows
    return "_".join(parts)


def parse_ptxas(text: str) -> dict:
    """-Xptxas -v output -> {kernel_key: {registers, spill_stores,
    spill_loads, stack}} (`kernel_key`: 'fused_f32', 'floor_f64', ...).
    The stack and spills are the entry function's own: the properties of
    the device functions it calls (`__internal_accurate_pow`, ...) follow
    it in the log and are not its."""
    out = {}
    name = mangled = None
    own = False
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            name = kernel_key(mangled)
            out[name] = {}
            own = True
            continue
        if name is None:
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            own = mangled.startswith(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and own:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def ptxas_summary(info: dict) -> list[str]:
    """One line per kernel; the instantiations of a template over integers
    (the overlap probe's variant and w) as one line with their range."""
    groups: dict = {}
    for key, r in info.items():
        base = re.sub(r"(_-?\d+)+$", "", key)
        groups.setdefault(base, []).append(r)
    lines = []
    for base, rs in groups.items():
        regs = [r.get("registers", 0) for r in rs]
        spill = max(r.get("spill_stores", 0) for r in rs)
        stack = max(r.get("stack", 0) for r in rs)
        span = f"{regs[0]}" if len(rs) == 1 else \
            f"{min(regs)}-{max(regs)} ({len(rs)} instantiations)"
        lines.append(f"{base}: {span} registers, {spill} B spill stores, "
                     f"{stack} B stack")
    return lines


def build(verbose: bool = True, ring=None, sources=None,
          version=None) -> Path:
    """Compile the sources (all of csrc/*.cu, or `sources`; K1's alone for
    a scheme version other than the reference's) with K1's ring geometry
    (`ring`) and scheme version (`version`, see `nvcc_flags`) unless this
    hash is already built; returns the library path, beside which
    `ptxas.log` holds ptxas' report. The default build records its seconds
    and ptxas' registers/spills in BUILD_INFO and prints them."""
    sources, version = _version_sources(sources, version)
    default = ring is None and sources is None and version is None
    flags = nvcc_flags(ring, version)
    srcs = _sources(sources)
    out_dir = BUILD_ROOT / source_hash(flags, sources)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    if lib_path.exists():
        if default:
            text = log_path.read_text() if log_path.exists() else ""
            BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True,
                              ptxas=parse_ptxas(text))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = out_dir / f".{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    text, failed = "", []
    for src, proc in zip(srcs, procs):
        log = proc.communicate()[0]
        text += log
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    seconds = time.perf_counter() - t0
    log_path.write_text(text)
    os.replace(tmp, lib_path)
    if not default:
        return lib_path
    info = parse_ptxas(text)
    BUILD_INFO.update(path=str(lib_path), seconds=seconds, cached=False,
                      ptxas=info)
    if verbose:
        print(f" cloudsc_tpu_torch: built {lib_path.name} in {seconds:.1f} s")
        for line in ptxas_summary(info):
            print(f"   {line}")
    return lib_path


def load_library(ring=None, sources=None, version=None):
    """The built library with its C entry points declared (builds on first
    use); `ring`, `sources` and `version` as for `build`. A library built
    from some of the sources declares the entry points it has; the default
    one all but `ALONE`'s."""
    sources, version = _version_sources(sources, version)
    key = (ring,
           tuple(sorted(map(str, sources))) if sources else None, version)
    if key in _libs:
        return _libs[key]
    lib = ctypes.CDLL(str(build(ring=ring, sources=sources, version=version)))
    alone = {n for names in ALONE.values() for n in names}
    for name, argtypes in ENTRY_POINTS.items():
        if (sources or name in alone or name in UNFOLDED_ONLY) \
                and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs[key] = lib
    return lib
