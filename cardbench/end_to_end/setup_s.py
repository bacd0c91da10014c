"""The set-up time: from the start of the process (imports, the card's
context, the data made from the seed, the model fitted, the kernels
built and every shape of the cell warmed) to the window's start."""


def read(window):
    return window.setup_s
