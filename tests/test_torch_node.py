"""The four-card node of the benchmark (`cellbench/configs/dp-node4-262k.json`,
the cell `dp-node4-262k.resident`) and the counters that show whether the
host keeps each card fed (`kernels.cuda_cloudsc.Feed`):

  * the node's mesh on four CPU shares of a few hundred columns, driven by
    the harness's resident loop (`CloudscDriver(devices=[cpu] * 4)`, one
    step and `assemble` a share), each share against the benchmark's
    plain reference (`cellbench.reference`), and the shares put back
    together against the reference over the whole uncut set of columns,
    fp64, within the configuration's limits;
  * the configuration file: its chips, columns, scheme and limits, its
    `source` and `reduced` as its `BENCHMARK.json` entry has them, and a
    node too large for one card;
  * `Feed` on stand-in events and the reader `card_dry_share` on
    synthetic counters: nothing without issues, the busiest card's share,
    nothing counted on the CPU or while a profiler records;
  * on a card (marker `cuda`, skips without one): back-to-back steps find
    the card busy, a sync between steps finds it drained every time.

The module imports no JAX, so that the card's case also runs with
`python -m pytest --noconftest -q tests/test_torch_node.py` on a GPU host.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from cellbench import inputs, loops, reference
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.params import Params
from cloudsc_tpu_torch.physics.scheme import SchemeConfig
from cloudsc_tpu_torch.runtime import tracing

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "dp-node4-262k"
CELL = f"{NAME}.resident"
CONFIG = json.loads((ROOT / "cellbench" / "configs" /
                     f"{NAME}.json").read_text())
JUBE = json.loads((ROOT / "cellbench" / "configs" /
                   "dp-jube.json").read_text())
RESIDENT = json.loads((ROOT / "cellbench" / "traffic" /
                       "resident.json").read_text())
SEED = 2**31 + 4099
# columns a share on the CPU: a multiple of the host's vector width
SHARE = 256
# bytes a column at dp-jube's peak: its memory_peak_bytes, 15,153,529,856
# (PERF.md §4), over its 163,840 columns
PEAK_BYTES_A_COLUMN = 15_153_529_856 / 163_840


@pytest.fixture
def registry():
    """A clean registry and feed, cleared again after the test."""
    tracing.reset()
    cc.FEED.last.clear()
    yield
    tracing.reset()
    cc.FEED.last.clear()


def _reader(name):
    path = ROOT / "cellbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the node's mesh on CPU shares against the reference ---------------

def test_node_mesh_matches_the_reference_by_share_and_whole(registry):
    cpu = torch.device("cpu")
    cell = loops.Cell(name=CELL, config={**CONFIG, "columns_per_chip": SHARE},
                      traffic=RESIDENT, seed=SEED, seconds=0.0, trace=False,
                      devices=[cpu] * CONFIG["chips"])
    loop = loops.Resident(cell, loops.Spans())
    assert loop.driver.ndevices == 4
    assert loop.shares == [(i * SHARE, (i + 1) * SHARE) for i in range(4)]
    outs = list(loop.unit())
    # each share against the reference stepped over that share
    per_share = loop.compare(outs)
    assert per_share.columns == 4 * SHARE
    assert per_share.correct(), per_share.report()
    # the shares put back together against the uncut node
    names = reference.Outputs._fields
    whole = {k: torch.cat([p[k] for p in loop.payloads], dim=-1)
             for k in loop.payloads[0]}
    ref = reference.step(whole, loop.ref_params, loop.ptsphy, loop.ref_config)
    got = [torch.cat([getattr(o, n) for o in outs], dim=-1) for n in names]
    node = loops.compare.Comparison(names, CONFIG["limits"])
    node.add(got, ref)
    assert node.columns == 4 * SHARE
    assert node.correct(), node.report()
    # no share is another's: the perturbation draws differ share by share
    pt = [p["pt"] for p in loop.payloads]
    assert not any(torch.equal(pt[0], t) for t in pt[1:])


# -- (b) the configuration file --------------------------------------------

def test_node_configuration():
    assert CONFIG["name"] == NAME
    assert CONFIG["chips"] == 4 and CONFIG["columns_per_chip"] == 262_144
    assert CONFIG["precision"] == "fp64" and CONFIG["levels"] == 137
    assert CONFIG["nproma"] == 128
    assert CONFIG["scheme"] == {"iwarmrain": 2, "ievaprain": 2,
                                "ievapsnow": 1, "idepice": 1}
    # the same precision and reference as dp-jube: its limits
    assert CONFIG["limits"] == JUBE["limits"] == {"rel_l1": 1e-7,
                                                  "rel_max": 1e-5}
    assert CONFIG["perturbation"] == JUBE["perturbation"]
    entry = next(c for c in BENCH["configs"] if c["name"] == NAME)
    assert entry["source"] == CONFIG["source"]
    assert entry["reduced"] == CONFIG["reduced"] == []
    assert entry["file"] == f"cellbench/configs/{NAME}.json"
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (NAME, "resident", 4)
    # the node's state does not fit one card: the four are needed
    node_bytes = PEAK_BYTES_A_COLUMN * CONFIG["columns_per_chip"] \
        * CONFIG["chips"]
    assert node_bytes > 80 * 2**30
    assert PEAK_BYTES_A_COLUMN * CONFIG["columns_per_chip"] < 80e9 / 2


# -- (c) the feed's counters and their reader ------------------------------

class _Event:
    """A card's event: `done` says whether the card has drained."""

    done = False

    def record(self, stream=None):
        self.recorded = True

    def query(self):
        return _Event.done


@pytest.fixture
def stand_in(monkeypatch):
    """A feed on stand-in events, usable without a card."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(_Event, "done", False)
    return cc.Feed(event=_Event)


def _counts():
    return tracing.keyed("feed.issues"), tracing.keyed("feed.dry")


def test_feed_counts_each_card(registry, stand_in):
    feed, card1, card3 = stand_in, torch.device("cuda", 1), \
        torch.device("cuda", 3)
    feed.check(card1)                 # a card's first step: nothing to ask
    assert _counts() == ({}, {})
    feed.issued(card1)
    feed.issued(card1)                # K1, then assemble: the last counts
    feed.check(card1)
    assert _counts() == ({1: 1}, {})
    assert len(feed.events) == 1      # one event a card, made once
    _Event.done = True
    feed.issued(card1)
    feed.issued(card3)
    feed.check(card1)
    feed.check(card3)
    feed.check(card3)                 # no record since the last check
    assert _counts() == ({1: 2, 3: 1}, {1: 1, 3: 1})
    assert set(feed.events) == {1, 3}


def test_feed_counts_nothing_on_the_cpu_or_under_a_profiler(registry,
                                                           stand_in):
    feed, card = stand_in, torch.device("cuda", 0)
    _Event.done = True
    feed.issued(torch.device("cpu"))
    feed.check(torch.device("cpu"))
    assert feed.events == {} and _counts() == ({}, {})
    feed.issued(card)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        feed.check(card)              # checked under the profiler
        feed.issued(card)             # and recorded under it
    feed.check(card)                  # a traced step is held against none
    assert _counts() == ({}, {})
    feed.issued(card)
    feed.check(card)
    assert _counts() == ({0: 1}, {0: 1})


def test_card_dry_share_reads_the_busiest_card(registry, monkeypatch):
    read = _reader("card_dry_share").read
    run = object()
    assert read(run) is None          # no issues: nothing to read
    tracing.count("feed.issues", 200, key=0)
    tracing.count("feed.dry", 1, key=0)
    tracing.count("feed.issues", 200, key=1)
    tracing.count("feed.issues", 100, key=2)
    tracing.count("feed.dry", 6, key=2)
    assert read(run) == pytest.approx(6.0)
    tracing.count("feed.dry", 200, key=1)
    assert read(run) == pytest.approx(100.0)
    # a program without the registry (an old one's) reads nothing
    monkeypatch.setitem(sys.modules, "cloudsc_tpu_torch.runtime.tracing",
                        None)
    monkeypatch.delattr(sys.modules["cloudsc_tpu_torch.runtime"], "tracing")
    assert read(run) is None


def test_cpu_steps_count_no_feed(registry):
    cpu = torch.device("cpu")
    cell = loops.Cell(name=CELL, config={**CONFIG, "columns_per_chip": 8},
                      traffic=RESIDENT, seed=SEED, seconds=0.0, trace=False,
                      devices=[cpu] * CONFIG["chips"])
    loop = loops.Resident(cell, loops.Spans())
    loop.unit()
    loop.unit()
    assert tracing.snapshot()["calls"]["cloudsc.step"] == 8
    assert _counts() == ({}, {})
    assert _reader("card_dry_share").read(object()) is None


# -- (d) on a card ---------------------------------------------------------

@pytest.mark.cuda
def test_feed_on_the_card(registry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    # the card's step (~8 ms in fp64) outlasts the host's issuing (~2 ms)
    ncol = 98_304
    fields, scalars = inputs.load_snapshot()
    amp = CONFIG["perturbation"]["relative"]
    snap = inputs.seeded_snapshot(fields, scalars, SEED, amp)
    p = inputs.field_dict(snap, ncol, "fp64", dev, amplitude=amp,
                          generator=inputs.share_generator(SEED, 0, dev))
    params = Params.from_scalars(scalars, rbeta=snap.get("YRECLDP_RBETA"),
                                 rbetap1=snap.get("YRECLDP_RBETAP1"))
    step = cc.FusedStep(params, float(scalars["PTSPHY"]), torch.float64,
                        SchemeConfig(**CONFIG["scheme"])).to(dev)

    def unit():
        return cc.assemble(step(p), p, step.c)

    out = unit()                      # builds K1 and foldo, warms up
    torch.cuda.synchronize(dev)
    out = unit()                      # the first step after a sync: dry
    assert _counts() == ({0: 1}, {0: 1})
    tracing.reset()
    for _ in range(30):               # back to back
        out = None
        out = unit()
    torch.cuda.synchronize(dev)
    issues, dry = _counts()
    assert issues == {0: 30}
    assert dry.get(0, 0) <= 3, dry
    tracing.reset()
    for _ in range(5):                # a sync between steps
        out = None
        out = unit()
        torch.cuda.synchronize(dev)
    assert _counts() == ({0: 5}, {0: 5})
    assert _reader("card_dry_share").read(object()) == 100.0
    del out
