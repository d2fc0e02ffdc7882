"""step_ms_p95.resnet: the 95th percentile of the steps' times by the host
clock, over every step of every job that ended inside the measured window,
in ms (a step from the end of the job's previous one, the first from the
window's start). Paced by how the driver time-slices the jobs' contexts."""
import statistics


def read(ctx):
    if ctx["spec"]["config_data"]["model"]["family"] != "resnet_v2":
        return None
    ms = ctx["run"]["step_ms"]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[-1]
