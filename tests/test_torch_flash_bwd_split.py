"""The split of the flash backward's dK / dV work at head_dim 256, on the
CPU (the kernels run only on the card: ``test_torch_kernels_cuda.py``,
``chip_smoke.py``).  At batch 1 with one kv head (recurrentgemma-2b's
MQA) a 64-key kv tile's work is its group's 10 query heads, and one
block a tile would fill half of the card; so the wrapper splits each
group over ``bwd_splits`` blocks, which write fp32 partials that a
fixed-order sum adds up.  Checked here:

* ``split_heads`` gives every head of a group to exactly one split, in
  order, for any group size and split count (even or not);
* the kernels cut the group with the same expression (read from the
  source, since they cannot run here);
* ``bwd_splits`` depends on the shape alone (it never asks the card),
  brings the hybrid's training shape to at least two blocks for each of
  the H100's 132 SMs, and is 1 where the unsplit grid already fills the
  card (smollm-135m's dense training shape, deepseek-moe-16b's d 128
  with one query head a kv head) and below head_dim 256.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import \
    flash_attention as fmod  # noqa: E402

SOURCE = (Path(fmod.__file__).resolve().parents[1] / "csrc"
          / "flash_attention_bwd.cu")


def _blocks(b, hkv, skv):
    return b * hkv * -(-skv // fmod.BWD_KV_TILE)


@pytest.mark.parametrize("g", [1, 2, 3, 5, 6, 10, 16])
def test_split_heads_cover_each_head_once(g):
    for splits in range(1, g + 1):
        ranges = fmod.split_heads(g, splits)
        assert len(ranges) == splits
        heads = [h for r in ranges for h in r]
        assert heads == list(range(g)), (g, splits)
        sizes = {len(r) for r in ranges}
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_kernels_cut_the_group_as_split_heads_does():
    text = SOURCE.read_text()
    body = re.search(r"int split_head\([^)]*\)\s*\{([^}]*)\}", text)
    assert body is not None
    assert " ".join(body.group(1).split()) == \
        "return hk * g + split * g / splits;"
    for g in (3, 10):
        for splits in range(1, g + 1):
            firsts = [r.start for r in fmod.split_heads(g, splits)]
            assert firsts == [s * g // splits for s in range(splits)]


# (b, hq, hkv, skv, d): the hybrid's training shape, smollm-135m's dense
# one, deepseek-moe-16b's attention (d 128, one query head a kv head) and
# the card tests' d 256 shapes
SHAPES = [(1, 10, 1, 4096, 256), (8, 9, 3, 2048, 64), (4, 16, 16, 2048, 128),
          (1, 10, 1, 300, 256), (1, 6, 2, 4480, 256), (1, 10, 1, 2560, 256),
          (2, 4, 2, 333, 256), (2, 4, 4, 150, 256)]


def test_bwd_splits_depends_on_the_shape_alone(monkeypatch):
    want = [fmod.bwd_splits(*s) for s in SHAPES]

    def refuse(*a, **kw):
        raise AssertionError("bwd_splits asked the card")

    for name in ("get_device_properties", "device_count",
                 "get_device_name", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert [fmod.bwd_splits(*s) for s in SHAPES] == want
    assert [fmod.bwd_splits(*s) for s in SHAPES] == want


def test_bwd_splits_fills_the_card_at_the_hybrid_shape():
    b, hq, hkv, skv, d = 1, 10, 1, 4096, 256
    splits = fmod.bwd_splits(b, hq, hkv, skv, d)
    assert _blocks(b, hkv, skv) == 64
    assert _blocks(b, hkv, skv) * splits >= 2 * 132
    assert splits == 5 and 1 <= splits <= hq // hkv


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_splits_is_the_fewest_that_fill_the_card(shape):
    b, hq, hkv, skv, d = shape
    g = hq // hkv
    splits = fmod.bwd_splits(*shape)
    assert 1 <= splits <= g
    if d != 256:
        assert splits == 1
        return
    blocks = _blocks(b, hkv, skv)
    assert blocks * splits >= fmod.SPLIT_TARGET_BLOCKS or splits == g
    assert splits == 1 or blocks * (splits - 1) < fmod.SPLIT_TARGET_BLOCKS


def test_bwd_splits_is_one_where_the_grid_is_full():
    assert fmod.bwd_splits(8, 9, 3, 2048, 64) == 1      # smollm, dense
    assert fmod.bwd_splits(4, 16, 16, 2048, 128) == 1   # deepseek, d 128
    assert fmod.bwd_splits(8, 10, 1, 4096, 256) == 1    # 512 blocks at d 256
    assert fmod.bwd_splits(1, 10, 1, 4096, 128) == 1    # below d 256


def test_card_tests_reach_an_uneven_split():
    """The card tests' shapes that split a group unevenly: g 3 over 2
    blocks and g 10 over 7."""
    for shape, splits in (((1, 6, 2, 4480, 256), 2),
                          ((1, 10, 1, 2560, 256), 7)):
        g = shape[1] // shape[2]
        assert fmod.bwd_splits(*shape) == splits
        assert g % splits
