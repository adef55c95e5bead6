"""Queries answered in the window over the window's seconds (host clock)."""


def read(obs):
    return obs["queries"] / obs["window_s"] if obs["queries"] else None
