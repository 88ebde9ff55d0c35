"""The roofline's least bytes on made-up launches: what a lane's
episodes share counts once a lane."""
from perfbench.reference import roofline


def _shape(episodes, steps=600, threads=4):
    return roofline.LaunchShape(
        steps=[steps, 300], episodes=episodes, n_tiles=[2, 4],
        n_threads=[threads, 3], n_accs=[9, 16])


def test_shared_rows_count_once_a_lane():
    count = roofline.episode_bytes
    one, many = count(_shape(1)), count(_shape(120))
    assert many - one > 0 and many < 120 * one
    # a wider schedule row (more slots) adds bytes once a lane, not once
    # an episode
    wide = count(_shape(120, threads=12)) - count(_shape(1, threads=12))
    assert wide == many - one


def test_episode_bytes_per_step():
    """An episode's step moves its noise and outputs (60 bytes); the
    schedule row is the lane's."""
    a = roofline.episode_bytes(_shape(10, steps=601))
    b = roofline.episode_bytes(_shape(10, steps=600))
    row = 4 * 4 + 2 + 2 + 4
    assert a - b == row + 10 * (9 * 4 + 6 * 4)
