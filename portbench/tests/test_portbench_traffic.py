"""The traffic generator: deterministic per seed, the seed changes the
token ids and never the sizes, the sizes stay within the mix's ranges."""
from __future__ import annotations

import numpy as np

from portbench import traffic

V = 49_152


def _routed(name, seed, cycle=0):
    return traffic.routed_cycle(traffic.load(name), seed, cycle, V, 0)


def test_same_seed_same_requests():
    a, b = _routed("code.routed", 2**31 + 17), _routed("code.routed",
                                                       2**31 + 17)
    assert [x.max_new_tokens for x in a] == [x.max_new_tokens for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_seeds_change_tokens_not_sizes():
    a, b = _routed("code.routed", 5), _routed("code.routed", 6)
    assert [(len(x.prompt), x.max_new_tokens) for x in a] == \
        [(len(y.prompt), y.max_new_tokens) for y in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = _routed("code.routed", 5, cycle=1)
    assert not np.array_equal(a[0].prompt, c[0].prompt)


def test_code_sizes_within_the_mix():
    mix = traffic.load("code.routed")
    items = _routed("code.routed", 9)
    assert len(items) == mix["sizes_per_cycle"]
    for it in items:
        total = len(it.prompt) + it.max_new_tokens
        assert 1024 <= total <= 4096
        assert 16 <= it.max_new_tokens <= 64
        assert it.prompt.dtype == np.int32 and it.prompt.max() < V
    gap = mix["arrival_gap_s"]
    assert [it.arrival_s for it in items] == [i * gap
                                              for i in range(len(items))]
    # log-uniform strata: the geometric mean of the totals is sqrt(lo hi)
    totals = [len(it.prompt) + it.max_new_tokens for it in items]
    assert abs(np.exp(np.mean(np.log(totals))) - 2048) < 40


def test_chat_sessions_carry_their_history():
    mix = traffic.load("chat.routed")
    items = _routed("chat.routed", 4)
    half = len(items) // 2
    for first, second in zip(items[:half], items[half:]):
        assert len(second.prompt) >= len(first.prompt)
        assert np.array_equal(second.prompt[:len(first.prompt)],
                              first.prompt)
    lo, hi = mix["total_tokens"]["lo"], mix["total_tokens"]["hi"]
    for it in items:
        assert lo <= len(it.prompt) <= hi
        assert mix["output_tokens"]["lo"] <= it.max_new_tokens <= \
            mix["output_tokens"]["hi"]


def test_engine_batches_share_one_prompt_length():
    mix = traffic.load("code.engine")
    batches = traffic.engine_cycle(mix, 11, 0, V)
    assert len(batches) == mix["sizes_per_cycle"]
    lengths = set()
    for b in batches:
        assert len(b) == mix["batch"]
        assert len({len(it.prompt) for it in b}) == 1
        lengths.add(len(b[0].prompt))
        for it in b:
            assert len(it.prompt) + it.max_new_tokens <= 4096
    assert len(lengths) == mix["sizes_per_cycle"]
