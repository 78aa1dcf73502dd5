"""The one traffic generator: the same seed gives the same inputs, another
seed another order of nearly the same work."""
import numpy as np
import pytest

from portbench import spec, traffic

SERVE_MIXES = ("chat-ds", "docs-backlog")


def _key(reqs):
    return [(r.t_due, r.prompt.tolist(), r.max_new) for r in reqs]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_same_seed_same_requests(name):
    mix = spec.traffic(name)
    a = traffic.serve_requests(mix, 2**31 + 17, 20.0, 1000)
    b = traffic.serve_requests(mix, 2**31 + 17, 20.0, 1000)
    assert _key(a) == _key(b)


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_other_seed_other_requests(name):
    mix = spec.traffic(name)
    a = traffic.serve_requests(mix, 2**31 + 17, 20.0, 1000)
    b = traffic.serve_requests(mix, 2**31 + 18, 20.0, 1000)
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in b]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_seeds_offer_nearly_the_same_work(name):
    """Stratified lengths: whole blocks hold one draw of every stratum, so
    two seeds' totals differ by less than a block's spread."""
    mix = spec.traffic(name)
    block = traffic.BLOCK
    tot = []
    for seed in (5, 6, 2**32 + 3):
        reqs = traffic.serve_requests(mix, seed, 50.0, 1000)
        n = len(reqs) // block * block
        tot.append(sum(len(r.prompt) + r.max_new for r in reqs[:n]))
    assert max(tot) / min(tot) < 1.05


def test_stratified_arrivals_at_the_mix_rate():
    mix = spec.traffic("chat-ds")
    rate = mix["arrivals"]["rate_per_s"]
    reqs = traffic.serve_requests(mix, 99, 50.0, 1000)
    due = np.array([r.t_due for r in reqs])
    assert np.all(np.diff(due) > 0) and due[-1] < 50.0
    assert abs(len(reqs) - 50.0 * rate) <= traffic.BLOCK


def test_lengths_stay_in_their_clips():
    for name in SERVE_MIXES:
        mix = spec.traffic(name)
        reqs = traffic.serve_requests(mix, 3, 50.0, 1000)
        p = [len(r.prompt) for r in reqs]
        o = [r.max_new for r in reqs]
        assert mix["prompt_len"]["min"] <= min(p)
        assert max(p) <= mix["prompt_len"]["max"]
        assert mix["output_len"]["min"] <= min(o)
        assert max(o) <= mix["output_len"]["max"]
        assert max(p) + max(o) <= mix["engine"]["max_len"]


def test_backlog_is_due_at_the_start():
    mix = spec.traffic("docs-backlog")
    reqs = traffic.serve_requests(mix, 1, 50.0, 1000)
    assert len(reqs) == mix["arrivals"]["requests"]
    assert all(r.t_due == 0.0 for r in reqs)


def test_train_batches_follow_the_seed():
    a = traffic.train_batches(2**31 + 5, 2, 16, 100)
    b = traffic.train_batches(2**31 + 5, 2, 16, 100)
    c = traffic.train_batches(2**31 + 6, 2, 16, 100)
    x, y, z = next(a), next(b), next(c)
    assert x.dtype == np.int32 and x.shape == (2, 16)
    assert np.array_equal(x, y) and not np.array_equal(x, z)
    assert not np.array_equal(next(a), x)


def test_check_sample_holds_the_longest():
    class R:
        def __init__(self, rid, p, o):
            self.rid, self.prompt, self.out_tokens = rid, [0] * p, [0] * o

    reqs = [R(i, 10 + i, 5) for i in range(20)]
    picked = traffic.check_sample(reqs, 7, 30)
    assert picked[0].rid == 19
    assert sum(len(r.out_tokens) for r in picked) >= 30
    assert [r.rid for r in traffic.check_sample(reqs, 7, 30)] == \
        [r.rid for r in picked]
