"""The frozen traffic generators draw what the program's own generators
draw, scene for scene."""

import numpy as np

from benchmark.traffic import scenes


def _same(a, b):
    for key in ("coordinates", "features", "labels", "raw_coordinates"):
        np.testing.assert_array_equal(a[key], b[key])


def test_rooms_equal_the_ports_at_seed_0():
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    params = dict(num_rooms_x=3, num_rooms_y=2, room_size=36, height=18,
                  jitter=0.3, dropout=0.2, multi_floor=True)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        _same(scenes.rooms_scene(r1, **params),
              make_synthetic_scene(r2, **params))


def test_bench_batches_equal_the_flagship_draw():
    """A batch of rooms-b8 is 8 draws of the bench's scene from one
    generator, as `profile_forward.flagship_items` draws them."""
    from mask3d_tpu_torch.profile_forward import flagship_items

    traffic = {"scene": "rooms", "batch_size": 8, "unique_batches": 1,
               "params": dict(num_rooms_x=3, num_rooms_y=2, room_size=36,
                              height=18, jitter=0.3, dropout=0.2,
                              multi_floor=True)}
    want = flagship_items(0)
    rng = np.random.default_rng(0)
    got = [scenes.rooms_scene(rng, **traffic["params"]) for _ in range(8)]
    for a, b in zip(got, want):
        _same(a, b)
    # the generator's own seeding: batch j of seed s from default_rng([s, j])
    batch = scenes.batches(traffic, 0)[0]
    rng = np.random.default_rng([0, 0])
    for item in batch:
        _same(item, scenes.rooms_scene(rng, **traffic["params"]))


def test_hall_equals_the_ports_at_seed_0():
    from mask3d_tpu_torch.bench_large_scene import make_hall_scene

    small = dict(length=96, width=40, height=16, n_boxes=5)
    _same(scenes.hall_scene(np.random.default_rng(0), **small),
          make_hall_scene(np.random.default_rng(0), **small))


def test_large_seeds_draw():
    traffic = {"scene": "rooms", "batch_size": 1, "unique_batches": 2,
               "params": dict(room_size=8, height=4)}
    a = scenes.batches(traffic, 2**31 + 12345)
    b = scenes.batches(traffic, 2**31 + 12345)
    _same(a[1][0], b[1][0])
    assert len(a[0][0]["coordinates"]) > 0
