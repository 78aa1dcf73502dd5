"""The port's fleet simulator against the reference's, exactly.

* Every scenario preset on both event cores: the port's
  ``trace.record(golden_sim(p, e)).dumps()`` is the reference's string,
  recorded in the same process (the committed ``tests/golden`` bytes are
  not the yardstick: re-simulating them differs from the files in the
  last digit of a float on some hosts).
* Each committed golden trace, loaded and replayed through the port,
  reproduces its recorded totals exactly (the files are only read).
* ``steady``, ``hetero_fleet`` and ``failure_storm`` at ``build_sim``'s
  defaults (200 jobs, 8 pods of 256, one week) give equal
  ``GoodputReport``s, with ``pg_table={}`` and with a table of six PGs.
* The resize pricing: ``param_inventory`` equals the reference's
  committed JSON for all ten architectures, ``reshard_seconds`` is equal
  bit for bit over the chip counts of ``SIZE_CHIPS``.
* The simulated TPU generations and their PG weights are the
  reference's; ``roofline_pg_table`` reads the port's table only.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.core import goodput as jgoodput  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.fleet import scenarios as jscen  # noqa: E402
from repro.fleet import trace as jtrace  # noqa: E402
from repro.fleet import workload as jwork  # noqa: E402
from repro.parallel import reshard as jreshard  # noqa: E402
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS  # noqa: E402
from repro_torch.core import goodput as tgoodput  # noqa: E402
from repro_torch.fleet import generations as tgen  # noqa: E402
from repro_torch.fleet import scenarios as tscen  # noqa: E402
from repro_torch.fleet import trace as ttrace  # noqa: E402
from repro_torch.fleet import workload as twork  # noqa: E402
from repro_torch.parallel import reshard as treshard  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRESETS = sorted(jscen.SCENARIOS)
ENGINES = ("reference", "vectorized")
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.jsonl"))
# six arbitrary per-arch PGs (the architectures the smoke trains)
PG_TABLE = {"smollm-135m": 0.0575, "deepseek-moe-16b": 0.0989,
            "recurrentgemma-2b": 0.069, "rwkv6-3b": 0.1005,
            "whisper-medium": 0.0418, "llava-next-mistral-7b": 0.1424}


def test_presets_and_golden_configuration_are_the_reference():
    assert sorted(tscen.SCENARIOS) == PRESETS == tscen.preset_names()
    for name in PRESETS:
        assert repr(tscen.SCENARIOS[name]) == repr(jscen.SCENARIOS[name])
    assert tscen.GOLDEN_KNOBS == jscen.GOLDEN_KNOBS
    assert tscen.GOLDEN_SIZE_MIX == jscen.GOLDEN_SIZE_MIX
    assert twork.ARCH_IDS == J_ARCH_IDS
    assert sorted(twork.ARCH_IDS) == sorted(T_ARCH_IDS)
    for k in ("SIZE_CHIPS", "SIZE_MIX_EARLY", "SIZE_MIX_LATE", "PHASE_MIX"):
        assert getattr(twork, k) == getattr(jwork, k)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("preset", PRESETS)
def test_golden_size_trace_is_the_reference_bytes(preset, engine):
    want = jtrace.record(jscen.golden_sim(preset, engine)).dumps()
    got = ttrace.record(tscen.golden_sim(preset, engine)).dumps()
    assert got == want


@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_committed_golden_trace_replays_to_its_totals(path):
    text = path.read_text()
    trace = ttrace.Trace.loads(text)
    assert ttrace.verify(trace) == trace.totals
    assert ttrace.replay(trace).totals() == trace.totals
    assert trace.dumps() == text


def _report(scen, preset, pg_table):
    sim = scen.build_sim(scen.SCENARIOS[preset], pg_table=pg_table)
    sim.run()
    return sim.report(), sim.ledger.totals()


@pytest.mark.parametrize("pg_table", [{}, PG_TABLE], ids=["draws", "table"])
@pytest.mark.parametrize("preset", ["steady", "hetero_fleet",
                                    "failure_storm"])
def test_default_size_report_is_the_reference(preset, pg_table):
    want_rep, want_tot = _report(jscen, preset, pg_table)
    got_rep, got_tot = _report(tscen, preset, pg_table)
    assert got_tot == want_tot
    assert got_rep.__dict__ == want_rep.__dict__
    assert got_rep.mpg == want_rep.mpg


def test_a_pg_table_changes_only_pg():
    """The fallback draw consumes the rng either way: SG and RG stay."""
    base, _ = _report(tscen, "steady", {})
    card, _ = _report(tscen, "steady", PG_TABLE)
    assert (card.sg, card.rg) == (base.sg, base.rg)
    assert card.pg != base.pg


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_inventory_is_the_committed_reference(arch):
    table = json.loads((ROOT / "src" / "repro" / "parallel"
                        / "param_inventory.json").read_text())
    got = [[list(shape), list(axes), itemsize]
           for shape, axes, itemsize in treshard.param_inventory(arch)]
    assert got == table[arch]


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_reshard_seconds_bit_for_bit(arch):
    chips = sorted({c for cs in twork.SIZE_CHIPS.values() for c in cs})
    assert treshard.OPT_STATE_FACTOR == jreshard.OPT_STATE_FACTOR
    for old in chips:
        for new in chips:
            assert (treshard.reshard_seconds(arch, old, new)
                    == jreshard.reshard_seconds(arch, old, new))
            assert (treshard.reshard_bytes_per_chip(arch, old, new)
                    == jreshard.reshard_bytes_per_chip(arch, old, new))


def test_generations_and_pg_weights_are_the_reference():
    assert tgen.DCN_BW_PER_CHIP == jhw.DCN_BW_PER_CHIP
    assert sorted(tgen.GENERATIONS) == sorted(jhw.GENERATIONS)
    for name, spec in tgen.GENERATIONS.items():
        assert spec.__dict__ == jhw.GENERATIONS[name].__dict__
    for gens in (["tpu-v5e"], ["tpu-v4", "tpu-v5p"],
                 ["tpu-v5p", "tpu-v5e", "tpu-v4", "tpu-v4"], []):
        assert (tgoodput.generation_pg_weights(gens)
                == jgoodput.generation_pg_weights(gens))
    with pytest.raises(ValueError, match="unknown hardware generation"):
        tgoodput.generation_pg_weights(["h100-sxm"])


def test_roofline_pg_table_reads_the_port_table_only(tmp_path, monkeypatch):
    assert twork.ROOFLINE_TABLE.parent.parent == ROOT / "build"
    touched = []
    for name in ("exists", "read_text"):
        real = getattr(pathlib.Path, name)

        def spy(self, *a, _real=real, **kw):
            touched.append(self.resolve())
            return _real(self, *a, **kw)
        monkeypatch.setattr(pathlib.Path, name, spy)
    twork.roofline_pg_table()
    assert touched and all(p == twork.ROOFLINE_TABLE for p in touched)
    assert not any("results" in p.parts for p in touched)
    monkeypatch.undo()
    tbl = tmp_path / "table.json"
    tbl.write_text(json.dumps([
        {"arch": "smollm-135m", "shape": "train_4k", "pg_overlap": 0.99},
        {"arch": "rwkv6-3b", "shape": "train_4k", "pg_overlap": 0.3},
        {"arch": "rwkv6-3b", "shape": "decode_32k", "pg_overlap": 0.1}]))
    monkeypatch.setattr(twork, "ROOFLINE_TABLE", tbl)
    assert twork.roofline_pg_table() == {"smollm-135m": 0.95,
                                         "rwkv6-3b": 0.3}


def test_refresh_golden_writes_only_where_named(tmp_path):
    with pytest.raises(ValueError, match="only read"):
        ttrace.refresh_golden(ttrace.GOLDEN_DIR)
    assert ttrace.REFRESH_DIR.parent == ROOT / "build"
    ttrace.main(["--record", "steady", "-o", str(tmp_path / "s.jsonl")])
    assert ((tmp_path / "s.jsonl").read_text()
            == jtrace.record(jscen.golden_sim("steady")).dumps())


def test_trace_cli_verifies_the_committed_goldens(capsys):
    ttrace.main(["--verify", *map(str, GOLDEN)])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"ok {p}" for p in GOLDEN]
