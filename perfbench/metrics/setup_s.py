"""Process start to the window's opening: imports, CUDA context, kernel
build or load, weights, capture of the cell's step tables, calibration.
"""


def read(run):
    return run.setup_s
