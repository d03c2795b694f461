"""The port's ranks and meshes on the CPU, with gloo (`runtime/dist.py`).

Counterpart of tests/test_multiprocess.py and tests/test_multidevice.py:

  * two ranks of `python -m cloudsc_tpu_torch 1 100 16 --device cpu
    --precision fp64`, launched as subprocesses with the `torchrun`
    variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    each writing its outputs with `--write-reference`: the file holds 100
    columns, NGPTOTG 100, so each rank reads its own 50 (true slicing) and
    its outputs equal the matching slice of a one-process run bit for bit;
    rank 0 alone prints the config line (NUMPROC=2), the per-rank perf rows
    and the table, which matches the JAX package's `validate_outputs` of
    the one-process run at rtol 1e-9 (the errsum is summed in another
    order over ranks, as in test_multiprocess);
  * the replicated regime, 400 columns over 2 ranks: the file is narrower
    than NGPTOTG, so each rank tiles the whole file and equals a
    200-column run (its written 100 columns bit for bit, its table the
    one-process 400-column table at rtol 1e-9);
  * `activity_perm(nshards=)` equals the JAX function; the collectives are
    the identity in one process; a rank with no columns raises, and in a
    run of two ranks makes both exit non-zero (the other's collective
    fails, it does not hang);
  * a mesh of two shares on the CPU (`devices=["cpu", "cpu"]`) equals one
    device bit for bit, for the kernel's plain version and the scan
    engine, at 256 columns: shares of 128, a multiple of the vector width
    (on the host two widths compare bit for bit only so);
  * the norms of shards reduced on the host against numpy, as
    test_multidevice's test_distributed_error_norms (rtol 1e-12 for min,
    max and maxerr, 1e-9 for the sums);
  * `validate.reference_on_device` takes a rank's slice, as
    `load_reference` does.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudsc_tpu.data.expand import activity_perm as jactivity_perm
from cloudsc_tpu.validate import validate_outputs as jvalidate_outputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch import validate as tvalidate
from cloudsc_tpu_torch.data.expand import activity_perm
from cloudsc_tpu_torch.params import Params
from cloudsc_tpu_torch.runtime import dist
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, nranks=2):
    """`python -m cloudsc_tpu_torch ARGS` as `nranks` processes of one gloo
    group; returns [(returncode, stdout, stderr)] in rank order."""
    port = _free_port()
    procs = []
    for r in range(nranks):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   RANK=str(r), WORLD_SIZE=str(nranks), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cloudsc_tpu_torch", *args], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    results = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err = f"rank {r} timed out\n{err}"
        results.append((p.returncode, out, err))
    return results


def run_ranks(args, tmp, nranks=2):
    """Ranks of `python -m cloudsc_tpu_torch ARGS --write-reference
    tmp/out.npz`, each of which must succeed; returns (stdouts, paths of
    the written outputs)."""
    results = launch([*args, "--write-reference", str(tmp / "out.npz")],
                     nranks)
    errs = [f"rank {r} rc={rc}\n{err[-2000:]}"
            for r, (rc, _, err) in enumerate(results) if rc != 0]
    assert not errs, "\n".join(errs)
    return ([out for _, out, _ in results],
            [tmp / f"out.rank{r}.npz" for r in range(nranks)])


def _table(text):
    """{field: [five numbers]} of a printed validation table."""
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 7 and parts[1].endswith(("D1", "D2", "D3")):
            rows[parts[0]] = [float(v) for v in parts[2:7]]
    return rows


def _one_process(ngptot):
    inp = tdata.load_input(tdata.default_input_path(), ngptot)
    driver = CloudscDriver(Params.from_input(inp), inp.ptsphy,
                           dtype=torch.float64, device="cpu", nproma=16)
    out, _, _ = driver.run(inp)
    return out


def _check_table(text, outputs, reference_100, ngptotg):
    """The printed table against the JAX package's `validate_outputs` of
    one process's outputs at rtol 1e-9."""
    from cloudsc_tpu.data.expand import expand_field

    ref = {k: expand_field(np.asarray(v), ngptotg)
           for k, v in reference_100.items()}
    expect = jvalidate_outputs(outputs, ref, ngptotg=ngptotg,
                               print_table=False)
    rows = _table(text)
    assert len(rows) == 21, f"validation table incomplete: {len(rows)} rows"
    for e in expect:
        want = [e.minval, e.maxval, e.maxerr, e.avgpgp, 100.0 * e.relerr]
        np.testing.assert_allclose(rows[e.name], want, rtol=1e-9,
                                   atol=1e-300, err_msg=e.name)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return run_ranks(["1", "100", "16", "--device", "cpu", "--precision",
                      "fp64"], tmp)


@pytest.fixture(scope="module")
def single_100():
    return _one_process(100)


def test_two_ranks_bitwise_equal_one_process(two_ranks, single_100):
    """Each rank's outputs == the matching 50-column slice of a
    one-process run, every field."""
    _, paths = two_ranks
    for r, path in enumerate(paths):
        fields, scalars = tdata._read(path)
        assert scalars["KLON"] == 50
        for name, attr in tvalidate.FIELD_ATTR.items():
            got = fields[tvalidate.REF_DATASET[name]]
            want = getattr(single_100, attr)[..., 50 * r:50 * (r + 1)]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"rank {r} {name}")


def test_two_ranks_table_and_gating(two_ranks, single_100, reference_100):
    (out0, out1), _ = two_ranks
    assert out0.count("NUMPROC=2, NUMOMP=1, NGPTOTG=100") == 1
    assert "@ rank#0" in out0 and "@ rank#1" in out0
    assert out0.count(": TOTAL") == 2
    # rank gating: rank 1 prints no config line, perf row or table
    assert "NUMPROC" not in out1 and "TOTAL" not in out1
    assert "Variable" not in out1 and "PLUDE" not in out1
    _check_table(out0, single_100, reference_100, 100)


def test_replicated_ranks_equal_a_half_width_run(tmp_path, reference_100):
    """400 columns over 2 ranks from a 100-column file: every rank tiles
    the whole file, as a 200-column run does."""
    (out0, _), paths = run_ranks(["1", "400", "16", "--device", "cpu",
                                  "--precision", "fp64"], tmp_path)
    half = _one_process(200)
    for r, path in enumerate(paths):
        fields, scalars = tdata._read(path)
        assert scalars["KLON"] == 100
        for name, attr in tvalidate.FIELD_ATTR.items():
            np.testing.assert_array_equal(
                fields[tvalidate.REF_DATASET[name]],
                getattr(half, attr)[..., :100], err_msg=f"rank {r} {name}")
    whole = type(half)(*(np.concatenate([a, a], axis=-1) for a in half))
    _check_table(out0, whole, reference_100, 400)


@pytest.mark.parametrize("nshards", [2, 3, 8])
def test_activity_perm_shards_equal_jax(input_100, params, nshards):
    f = input_100.fields
    args = (f["PCLV"], f["TENDENCY_TMP_CLD"], input_100.ptsphy,
            params.ydecldp.rlmin)
    got = activity_perm(*args, nshards=nshards)
    np.testing.assert_array_equal(got, jactivity_perm(*args,
                                                      nshards=nshards))
    assert sorted(got) == list(range(100))


def test_collectives_are_identity_in_one_process():
    assert not dist.initialize()  # no WORLD_SIZE > 1 here
    assert (dist.rank(), dist.world_size()) == (0, 1)
    norms = np.random.default_rng(0).normal(size=(21, 5))
    np.testing.assert_array_equal(dist.allreduce_field_norms(norms), norms)
    rows = dist.gather_perf_rows(1.25, 300)
    assert rows.shape == (1, 2) and rows.dtype == np.float64
    np.testing.assert_array_equal(rows, [[1.25, 300.0]])


def test_rank_shares_and_an_empty_rank():
    """The reference's ceil share, the last rank the rest; a rank left with
    nothing raises, naming the counts."""
    assert [dist.rank_share(100, r, 2) for r in range(2)] == [50, 50]
    assert [dist.rank_share(10, r, 3) for r in range(3)] == [4, 4, 2]
    assert sum(dist.rank_share(163840, r, 7) for r in range(7)) == 163840
    with pytest.raises(ValueError, match="rank 3 of 4 gets no columns"):
        dist.rank_share(6, 3, 4)
    assert dist.split_columns(10, 3) == [(0, 4), (4, 7), (7, 10)]
    with pytest.raises(ValueError, match="2 columns cannot fill 3"):
        dist.split_columns(2, 3)


def test_a_failing_rank_fails_the_run():
    """NGPTOTG 1 over 2 ranks: rank 1 has no column and exits with the
    parser's error; rank 0 then fails in the perf gather (the peer closed
    its connection) instead of waiting."""
    (rc0, out0, err0), (rc1, _, err1) = launch(
        ["1", "1", "16", "--device", "cpu", "--precision", "fp64"])
    assert rc1 == 2 and "rank 1 of 2 gets no columns" in err1
    assert rc0 not in (0, None) and "timed out" not in err0
    assert "NUMPROC=2" in out0 and "Variable" not in out0


def test_rank_device_and_mesh_devices():
    assert dist.rank_device("cpu") == torch.device("cpu")
    assert dist.column_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="all cards or all CPU"):
        dist.column_devices(["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            dist.rank_device("cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            dist.column_devices(None)


@pytest.mark.parametrize("backend", ["auto", "scan"])
def test_cpu_mesh_bitwise_equals_one_device(backend):
    """Two shares on the CPU == one device, all 21 fields; two timer rows;
    without fetching, one CloudscOutputs a share, in canonical order."""
    inp = tdata.load_input(tdata.default_input_path(), 256)
    params = Params.from_input(inp)
    one, _, _ = CloudscDriver(params, inp.ptsphy, torch.float64, "cpu",
                              backend=backend).run(inp)
    mesh = CloudscDriver(params, inp.ptsphy, torch.float64, backend=backend,
                         devices=["cpu", "cpu"])
    shards, _, timer = mesh.run(inp, fetch_outputs=False)
    assert timer.device_cols == [128, 128]
    assert [c for _, c in mesh.out_shares] == [(0, 128), (128, 256)]
    for name in one._fields:
        got = torch.cat([getattr(s, name) for s in shards], -1).numpy()
        np.testing.assert_array_equal(got, getattr(one, name), err_msg=name)


def test_shard_norms_against_numpy():
    """Norms of three shards reduced on the host (`error_norms` a shard,
    `reduce_norms` over them, as `validate.device_field_norms` does on a
    mesh) against numpy, as test_multidevice's
    test_distributed_error_norms."""
    rng = np.random.default_rng(0)
    field = rng.normal(size=(137, 800))
    ref = field + rng.normal(scale=1e-9, size=field.shape)
    cuts = [(0, 300), (300, 301), (301, 800)]
    got = dist.reduce_norms([
        dist.error_norms(torch.from_numpy(field[:, a:b]),
                         torch.from_numpy(ref[:, a:b])).numpy()
        for a, b in cuts])
    np.testing.assert_allclose(got[0], field.min(), rtol=1e-12)
    np.testing.assert_allclose(got[1], field.max(), rtol=1e-12)
    np.testing.assert_allclose(got[2], np.abs(field - ref).max(), rtol=1e-12)
    np.testing.assert_allclose(got[3], np.abs(field - ref).sum(), rtol=1e-9)
    np.testing.assert_allclose(got[4], np.abs(ref).sum(), rtol=1e-9)


def test_reference_on_device_takes_the_rank_slice(tmp_path):
    """A rank's reference on the device equals `load_reference`'s rank
    slice (true slicing: rank 1 of 2 holds file columns 50-99), and a
    mesh share's columns equal that slice of the expansion."""
    path = tdata.default_reference_path()
    got = tvalidate.reference_on_device(path, 50, "cpu", 100, 1, 2)
    want = tdata.load_reference(path, 50, 100, 1, 2)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    got = tvalidate.reference_on_device(path, 300, "cpu", columns=(120, 250))
    want = tdata.load_reference(path, 300)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v[..., 120:250],
                                      err_msg=k)


def test_pod_sharding_example_on_cpu(capsys):
    from cloudsc_tpu_torch.examples import pod_sharding

    assert pod_sharding.main(["--devices", "cpu,cpu", "--ngptot", "256",
                              "--precision", "fp64",
                              "--iterations", "1"]) == 0
    out = capsys.readouterr().out
    assert "2 devices (cpu, cpu), 256 columns, fp64" in out
    rows = _table(out)
    assert len(rows) == 21 and "!!!!" not in out
