"""torch.cuda.max_memory_allocated() over the window, reset after set-up."""


def read(run):
    return run["window"]["peak_bytes"] / 2 ** 30
