"""The JUBE analogue over the port: a grid of CLI runs, or the weak scaling
of the bench entry.

Counterpart of the JAX package's `bench/sweep.py`, whose scrape targets it
keeps (the reference's JUBE patternset, ref:
benchmark/include/include_patternset.yml:162-173).

Grid mode runs `python -m cloudsc_tpu_torch 1 NGPTOT NPROMA --kernel K
--precision P --iterations N` for every point of --ngptot x --nproma x
--kernel x --precision, each in a process of its own, and scrapes the
TOTAL row (`RE_TOTAL`), the `device compute` line (`RE_DEVICE`) and, with
--validate, the validation table's `!!!!` flags. Beside them each record
holds the host wall time of the process and, on the card, the CLI's peak
device memory line (`RE_PEAK`). In fp64 each flagged field's MaxRelErr is
judged by `fp64_verdict`, the bar chip_smoke holds its fp64 runs to: it
passes under FP64_TOL and at or below the larger of the 10*eps flag bar
and the JAX package's fp64 engine's own reading at that size
(`JAX_FP64_RELERR`, for the sizes it lists). A point that fails it fails
the sweep, as a failed run does.

`--weak-scaling N ...` runs `python -m cloudsc_tpu_torch.bench.bench` with
CLOUDSC_BENCH_MESH=1 and CUDA_VISIBLE_DEVICES set to the first N cards:
every card takes the bench entry's default columns (163,840 a card, 8,192
a share with --cpu), and the value is columns/s per card. The efficiency
is each N's value over the smallest N's, and there is none when that run
failed. An N above `torch.cuda.device_count()` is refused. With --cpu the
N shares run on the host (CLOUDSC_BENCH_CPU_DEVICES), a rehearsal of the
sharded path: they run one after another, so the value per share falls
~1/N by construction, and the records say so (`rehearsal`,
`serialized_efficiency`).

In grid mode --cpu passes --device cpu (tests and small sizes only).

    python -m cloudsc_tpu_torch.bench.sweep [--ngptot 16384 65536 163840]
        [--nproma 128] [--kernel cuda scan] [--precision fp32 fp64]
        [--iterations 3] [--validate] [--out FILE]
    python -m cloudsc_tpu_torch.bench.sweep --weak-scaling 1 2 4
        [--iterations N]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "cloudsc_tpu_torch" / "sweep.json"
CASE_TIMEOUT_S = 1200

# the same scrape targets JUBE uses (ref: include_patternset.yml:162-173)
RE_TOTAL = re.compile(
    r"^\s*\d+\s*x\s*\d+\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+-1\s*:"
    r"\s*(\d+)\s+(\d+)\s+(\d+)\s*:\s*TOTAL$"
)
RE_DEVICE = re.compile(
    r"device compute:\s*([0-9.]+) ms \| h2d:\s*([0-9.]+) ms \| "
    r"d2h:\s*([0-9.]+) ms \| compile:\s*([0-9.]+) s"
)
RE_FLAGGED = re.compile(r"!!!!\s*$")
# the CLI's line on the card, and a validation row's name and MaxRelErr-%
RE_PEAK = re.compile(r"peak device memory:\s*([0-9.]+) MiB")
RE_ROW = re.compile(r"^ (\S+)\s+\dD\d(?:\s+\S+){4}\s+(\S+)")

# test_golden's fp64 bar (errsum/refsum) and validate's flag bar, 10*eps
FP64_TOL = 5.0e-14
FLAG_BAR = 10.0 * 2.220446049250313e-16
# The JAX package's fp64 engine (the XLA scan on the CPU) against the
# reference: validate's MaxRelErr per field at each size, the fields not
# listed reading 0. Its columns are exact copies of the 100-column run's,
# so each follows from that run weighted by each column's copy count
# (tests/test_torch_driver.py recomputes them).
_JAX_FLUX = ("PCOVPTOT", "PFSQLF", "PFSQIF", "PFSQRF", "PFSQSF", "PFPLSN",
             "PFHPSN", "TENDENCY_LOC%A", "TENDENCY_LOC%T")
JAX_FP64_RELERR = {
    16384: dict(zip(_JAX_FLUX, (
        2.979645543940182e-17, 1.8925271678549484e-14, 9.520294300761633e-15,
        1.9173690692203085e-14, 9.485653789984515e-15, 2.4276780487900045e-15,
        2.4278058599474728e-15, 2.4637289176333626e-15, 9.84621151302806e-15))),
    65536: dict(zip(_JAX_FLUX, (
        2.978454898677521e-17, 1.8896456633489282e-14, 9.515516873894595e-15,
        1.9144447749677157e-14, 9.48097588188974e-15, 2.426500441089243e-15,
        2.4266299865652804e-15, 2.4639810109831807e-15,
        9.844120615450657e-15))),
    163840: dict(zip(_JAX_FLUX, (
        2.9787054195918165e-17, 1.8894803421667218e-14, 9.516770899673154e-15,
        1.9142795253811026e-14, 9.482191141213821e-15, 2.4265917257707723e-15,
        2.426721006132933e-15, 2.463951279120334e-15, 9.84419829278889e-15))),
    245760: dict(zip(_JAX_FLUX, (
        2.978959648951141e-17, 1.8894662282457225e-14, 9.516941899634248e-15,
        1.9142657744528095e-14, 9.482341771497072e-15, 2.4266619535998377e-15,
        2.426791079477184e-15, 2.4639754940010022e-15,
        9.844388885441208e-15))),
    327680: dict(zip(_JAX_FLUX, (
        2.978862969758668e-17, 1.889640763555318e-14, 9.517724573970747e-15,
        1.9144436700923006e-14, 9.48312356703256e-15, 2.4266851281559363e-15,
        2.42681418699433e-15, 2.4638970667738912e-15,
        9.844374628802415e-15))),
    409600: {**dict(zip(_JAX_FLUX, (
        2.978842602686721e-17, 1.889493372825345e-14, 9.517585105415056e-15,
        1.914294194926662e-14, 9.482985452401648e-15, 2.4266258469524837e-15,
        2.4267549020689807e-15, 2.463980173720848e-15,
        9.844271960754897e-15))),
        "TENDENCY_LOC%Q": 8.238223799680386e-15},
}


def fp64_verdict(ngptot: int, flagged: dict) -> dict:
    """The judgement of fp64 MaxRelErrs ({field: MaxRelErr}) at `ngptot`
    columns: the fields at or over FP64_TOL, and those above both the flag
    bar and the JAX engine's reading (None where the table has no row for
    the size)."""
    over_tol = {k: v for k, v in flagged.items() if not v < FP64_TOL}
    jax = JAX_FP64_RELERR.get(ngptot)
    over_jax = None if jax is None else {
        k: v for k, v in flagged.items()
        if not v <= max(FLAG_BAR, jax.get(k, 0.0))}
    return dict(over_fp64_tol=over_tol, over_jax_reading=over_jax)


def scrape(stdout: str) -> dict:
    """The JUBE targets of one CLI run's output: the TOTAL row, the device
    line, the peak memory line, and the flagged validation rows
    ({field: MaxRelErr as a fraction})."""
    rec = {}
    flagged = {}
    for line in stdout.splitlines():
        m = RE_TOTAL.match(line)
        if m:
            rec["time_ms"] = int(m.group(5))
            rec["mflops"] = int(m.group(6))
            rec["cols_per_s"] = int(m.group(7))
        m = RE_DEVICE.search(line)
        if m:
            rec["compute_ms"] = float(m.group(1))
            rec["h2d_ms"] = float(m.group(2))
            rec["d2h_ms"] = float(m.group(3))
            rec["compile_s"] = float(m.group(4))
        m = RE_PEAK.search(line)
        if m:
            rec["peak_mib"] = float(m.group(1))
        if RE_FLAGGED.search(line):
            m = RE_ROW.match(line)
            flagged[m.group(1)] = float(m.group(2)) / 100.0
    rec["validation_flags"] = len(flagged)
    rec["flagged"] = flagged
    return rec


def run_case(ngptot: int, nproma: int, kernel: str, precision: str,
             iterations: int, validate: bool, cpu: bool) -> dict:
    cmd = [sys.executable, "-m", "cloudsc_tpu_torch", "1", str(ngptot),
           str(nproma), "--kernel", kernel, "--precision", precision,
           "--iterations", str(iterations)]
    if not validate:
        cmd.append("--no-validate")
    if cpu:
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=CASE_TIMEOUT_S)
    rec = dict(ngptot=ngptot, nproma=nproma, kernel=kernel,
               precision=precision, iterations=iterations,
               rc=proc.returncode, wall_s=time.perf_counter() - t0)
    rec.update(scrape(proc.stdout))
    if validate and precision == "fp64":
        rec.update(fp64_verdict(ngptot, rec["flagged"]))
    if proc.returncode != 0:
        rec["stderr_tail"] = proc.stderr[-500:]
    return rec


def passed(rec: dict) -> bool:
    """A point ran to exit 0 and, where it was judged, no fp64 field is
    over FP64_TOL or the JAX engine's reading."""
    return rec["rc"] == 0 and not rec.get("over_fp64_tol") \
        and not rec.get("over_jax_reading")


def efficiencies(results: list, cpu: bool):
    """Each record's `efficiency` (its value over the smallest N's), and
    with `cpu` its `serialized_efficiency` (N x value over the smallest
    N's: the ideal when N shares take turns on one host). The base is
    strictly the smallest N: if that run failed, every efficiency is None
    rather than one rebased on a larger N. Returns the base value."""
    smallest = min(results, key=lambda r: r["ndev"])
    base = smallest.get("value") if smallest["rc"] == 0 else None
    for r in results:
        v = r.get("value")
        r["efficiency"] = round(v / base, 4) if (v and base) else None
        if cpu:
            r["serialized_efficiency"] = (
                round(r["ndev"] * v / base, 4) if (v and base) else None)
    return base


def run_weak_scaling(device_counts, cpu: bool, iterations) -> list:
    results = []
    for ndev in device_counts:
        env = dict(os.environ, CLOUDSC_BENCH_MESH="1")
        if cpu:
            env.update(CLOUDSC_BENCH_CPU="1",
                       CLOUDSC_BENCH_CPU_DEVICES=str(ndev))
        else:  # the first N of the cards this process sees
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            cards = visible.split(",") if visible else map(str, range(ndev))
            env["CUDA_VISIBLE_DEVICES"] = ",".join(list(cards)[:ndev])
        if iterations:
            env["CLOUDSC_BENCH_ITERS"] = str(iterations)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cloudsc_tpu_torch.bench.bench"],
            capture_output=True, text=True, cwd=ROOT, timeout=CASE_TIMEOUT_S,
            env=env)
        rec = dict(ndev=ndev, rc=proc.returncode,
                   wall_s=time.perf_counter() - t0)
        if cpu:
            # the data says it, not only the printout: N shares take turns
            # on one host, so the value per share falls ~1/N by construction
            rec["rehearsal"] = True
            rec["rehearsal_reason"] = (
                "CPU mesh: every share runs on one host, one after another; "
                "validates the sharded path, NOT an efficiency measurement")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec.update(json.loads(line))
        if proc.returncode != 0:
            rec["stderr_tail"] = proc.stderr[-500:]
        results.append(rec)
        print(f"  ndev={ndev}: {rec.get('value', 'FAILED')} cols/s/chip",
              flush=True)

    base = efficiencies(results, cpu)
    if cpu:
        print("\n[REHEARSAL] CPU mesh: the efficiencies below measure shares "
              "taking turns on one host, not scaling over cards")
    hdr = f"{'ndev':>5} {'cols/s/chip':>14} {'efficiency':>11}"
    print("\n" + hdr + "\n" + "-" * len(hdr))
    for r in results:
        v = r.get("value")
        eff = r["efficiency"]
        eff_s = f"{eff:>10.1%}" if eff else f"{'n/a':>10}"
        ser = r.get("serialized_efficiency")
        ser_s = f"  (serialization-adjusted {ser:.1%})" if ser else ""
        print(f"{r['ndev']:>5} {v if v else -1:>14} {eff_s}{ser_s}")
    if base is None:
        smallest = min(device_counts)
        print(f"\nWARNING: ndev={smallest} baseline run failed; "
              "efficiencies not computed")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.sweep",
        description="CLOUDSC benchmark sweep over the PyTorch port")
    p.add_argument("--ngptot", type=int, nargs="+",
                   default=[16384, 65536, 163840])
    p.add_argument("--nproma", type=int, nargs="+", default=[128])
    p.add_argument("--kernel", nargs="+", default=["cuda", "scan"],
                   choices=["auto", "cuda", "scan"])
    p.add_argument("--precision", nargs="+", default=["fp32"],
                   choices=["fp32", "fp64"])
    p.add_argument("--iterations", type=int, default=None,
                   help="timed steps a point (grid default 3; weak scaling: "
                        "the bench entry's default)")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--weak-scaling", type=int, nargs="+", metavar="NDEV",
                   default=None,
                   help="weak scaling of the bench entry over these card "
                        "counts (e.g. --weak-scaling 1 2 4)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU: the grid with --device cpu, weak "
                        "scaling over N shares of the host (a rehearsal)")
    a = p.parse_args(argv)

    if a.weak_scaling:
        if min(a.weak_scaling) < 1:
            p.error("--weak-scaling counts must be >= 1")
        if not a.cpu:
            import torch

            have = torch.cuda.device_count()
            if max(a.weak_scaling) > have:
                p.error(f"--weak-scaling {max(a.weak_scaling)} needs that "
                        f"many cards and torch.cuda.device_count() is "
                        f"{have} (--cpu rehearses on the host)")
        results = run_weak_scaling(a.weak_scaling, a.cpu, a.iterations)
    else:
        iterations = a.iterations or 3
        results = []
        for ng, npr, kern, prec in itertools.product(
                a.ngptot, a.nproma, a.kernel, a.precision):
            print(f"== ngptot={ng} nproma={npr} kernel={kern} "
                  f"precision={prec}", flush=True)
            rec = run_case(ng, npr, kern, prec, iterations, a.validate,
                           a.cpu)
            results.append(rec)
            print("   ", {k: rec.get(k) for k in
                          ("time_ms", "cols_per_s", "compute_ms",
                           "peak_mib", "validation_flags", "rc")},
                  flush=True)
        hdr = (f"{'ngptot':>8} {'nproma':>7} {'kernel':>7} {'prec':>5} "
               f"{'ms':>8} {'MF/s':>10} {'col/s':>12}")
        print("\n" + hdr + "\n" + "-" * len(hdr))
        for r in results:
            print(f"{r['ngptot']:>8} {r['nproma']:>7} {r['kernel']:>7} "
                  f"{r['precision']:>5} {r.get('time_ms', -1):>8} "
                  f"{r.get('mflops', -1):>10} {r.get('cols_per_s', -1):>12}")

    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"\nwrote {out}")
    return 0 if all(passed(r) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
