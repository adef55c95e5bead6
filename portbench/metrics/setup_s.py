"""Seconds from the process's start to the window's: imports, kernels
loaded or built, data made from the seed, the index built, the warm-up."""


def read(obs):
    return obs["setup_s"]
