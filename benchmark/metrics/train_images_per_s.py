"""Every image of every training step issued in the window, over the
window's seconds (host clock, from a synchronise to the synchronise after
the last step)."""


def read(run):
    if run.unit != "images" or run.window_s <= 0:
        return None
    return run.units / run.window_s
