"""The traffic generator: the same seed gives the same requests, every
seed the same sizes and arrivals in another order, and the lengths follow
the mixes' distributions within their clips."""

import itertools
import json
import os
import statistics

from gpubench import traffic

MIXES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")
BIG = 2 ** 31 + 12345


def mix(name):
    with open(os.path.join(MIXES, name + ".json")) as f:
        return json.load(f)


def test_open_schedule_deterministic_and_seed_only_reorders():
    m = mix("chat")
    a = traffic.open_schedule(m, BIG, 45, 32000)
    assert a == traffic.open_schedule(m, BIG, 45, 32000)
    b = traffic.open_schedule(m, 7, 45, 32000)
    for phase in ("warmup", "window", "tail"):
        ra = [r for r in a if r["phase"] == phase]
        rb = [r for r in b if r["phase"] == phase]
        assert len(ra) == len(rb) == max(1, round(
            m["rate_per_s"] * {"warmup": m["warmup_s"], "window": 45,
                               "tail": m["tail_s"]}[phase]))
        assert sorted(len(r["prompt"]) for r in ra) == \
            sorted(len(r["prompt"]) for r in rb)
        assert sorted(r["max_tokens"] for r in ra) == \
            sorted(r["max_tokens"] for r in rb)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]


def test_window_spans_exactly_the_window():
    m = mix("chat")
    s = traffic.open_schedule(m, 3, 45, 32000)
    w = [r["due_s"] for r in s if r["phase"] == "window"]
    assert abs(w[0] - m["warmup_s"]) < 1e-9
    t = [r["due_s"] for r in s if r["phase"] == "tail"]
    assert abs(t[0] - (m["warmup_s"] + 45)) < 1e-6
    assert all(b >= a for a, b in zip(w, w[1:]))


def test_lengths_follow_the_mix():
    for name in ("chat", "docs"):
        m = mix(name)
        rs = list(itertools.islice(traffic.closed_stream(m, BIG, 32000),
                                   1024))
        for key, get in (("prompt_tokens", lambda r: len(r["prompt"])),
                         ("output_tokens", lambda r: r["max_tokens"])):
            d = m[key]
            vals = [get(r) for r in rs]
            assert min(vals) >= d["min"] and max(vals) <= d["max"]
            assert abs(statistics.median(vals) - d["median"]) \
                <= 0.02 * d["median"] + 1
        assert all(0 <= t < 32000 for r in rs for t in r["prompt"])


def test_quantile_grid_is_lognormal():
    d = {"median": 512, "sigma": 0.8, "min": 1, "max": 10 ** 9}
    v = traffic.lengths(4001, d)
    import math
    logs = [math.log(x) for x in v]
    assert abs(statistics.median(v) - 512) <= 1
    assert abs(statistics.pstdev(logs) - 0.8) < 0.02


def test_gaps_sum_to_the_span():
    g = traffic.gaps(90, 45.0)
    assert abs(sum(g) - 45.0) < 1e-9 and min(g) > 0


def test_order_seed_fixes_the_order_and_the_seed_draws_the_ids():
    m = mix("chat")
    assert "order_seed" in m
    a = traffic.open_schedule(m, BIG, 45, 32000)
    b = traffic.open_schedule(m, 7, 45, 32000)
    shape = [[(len(r["prompt"]), r["max_tokens"], r["due_s"], r["phase"])
              for r in s] for s in (a, b)]
    assert shape[0] == shape[1]
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]
    free = dict(m)
    del free["order_seed"]
    c = traffic.open_schedule(free, 7, 45, 32000)
    assert [len(r["prompt"]) for r in c] != [len(r["prompt"]) for r in b]
