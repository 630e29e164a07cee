"""The request generator: the same (seed, index) gives the same request."""

from hhbench import generator

DRAW = {"strike": {"choice": [80.0, 90.0, 100.0, 110.0]},
        "start_scale": {"uniform": [-0.1, 0.1], "size": 5}}


def test_same_seed_same_requests():
    a = [generator.request_spec(2**31 + 5, i, DRAW) for i in range(50)]
    b = [generator.request_spec(2**31 + 5, i, DRAW) for i in range(50)]
    assert a == b


def test_seeds_and_indices_give_other_requests():
    a = [generator.request_spec(7, i, DRAW) for i in range(50)]
    b = [generator.request_spec(8, i, DRAW) for i in range(50)]
    assert len({s["seed"] for s in a}) == 50
    assert [s["seed"] for s in a] != [s["seed"] for s in b]
    assert len({s["strike"] for s in a}) == 4


def test_fields_in_range_and_large_or_negative_seeds():
    for seed in (0, -3, 2**40 + 1, 2**64 + 9):
        s = generator.request_spec(seed, 3, DRAW)
        assert 0 <= s["seed"] < 2**31
        assert s["strike"] in DRAW["strike"]["choice"]
        assert len(s["start_scale"]) == 5 and all(-0.1 <= x < 0.1 for x in s["start_scale"])
    assert generator.request_spec(2**64 + 9, 3, DRAW) == generator.request_spec(9, 3, DRAW)


def test_sample_is_drawn_from_the_seed():
    pop = list(range(100))
    assert generator.sample(5, pop, 4, salt=1) == generator.sample(5, pop, 4, salt=1)
    assert generator.sample(5, pop, 4, salt=1) != generator.sample(6, pop, 4, salt=1)
    assert generator.sample(5, pop[:3], 4, salt=1) == [0, 1, 2]
