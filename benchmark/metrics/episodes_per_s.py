"""Every episode scored in the window, over the window's seconds (host
clock, from a synchronise to the synchronise after the last whole call)."""


def read(run):
    if run.unit != "episodes" or run.window_s <= 0:
        return None
    return run.units / run.window_s
