"""The share of the traced stretch in which no operation ran on the
card, leaving out the idle time during CUDA-graph launches: under the
profiler a launch pays for each node of its graph on the host, which it
does not in an untraced run, so that time is the profiler's (both the
idle time and the stretch lose it)."""


def read(w):
    tr = w.trace
    if tr is None or tr.window_s <= 0:
        return None
    launch = tr.graph_launch_idle_s()
    idle = tr.window_s - tr.busy_s() - launch
    return idle / (tr.window_s - launch)
