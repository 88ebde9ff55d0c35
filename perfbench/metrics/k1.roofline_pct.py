"""K1's share of its roofline: the least time of the window's K1
launches (their bytes from the cell's shapes,
``perfbench.reference.roofline.episode_bytes``, over the card's peak
bandwidth) over the device time of the kernels named
``soc_step_episode_kernel<false, false`` (healthy, table agents)."""
from perfbench.reference import roofline

KERNEL = "soc_step_episode_kernel<false, false"


def read(run):
    s, k1 = run.summary, run.facts.get("k1")
    if s is None or k1 is None:
        return None
    times = s.kernel_times(KERNEL)
    launches = run.facts["units"] * k1["launches_per_unit"]
    if times.size == 0 or times.size != launches:
        return None
    least_s = run.facts["units"] * k1["bytes_per_unit"] / \
        roofline.PEAK_BYTES_PER_S
    return 100.0 * least_s / (times.sum() * 1e-6)
