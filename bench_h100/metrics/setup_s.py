"""Set-up seconds: from the start of the process to the window, the first
kernel build, the inputs, the weights and the three warm-up steps included."""


def read(run):
    return run["setup_s"]
