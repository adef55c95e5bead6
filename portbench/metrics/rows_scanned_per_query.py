"""The program's own counter ``IVFIndex.scan_rows``: its change over the
window over the queries answered."""


def read(obs):
    return obs["scan_rows"] / obs["queries"] if obs["queries"] else None
