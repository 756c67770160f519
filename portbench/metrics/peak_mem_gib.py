"""The card's allocator peak (`torch.cuda.max_memory_allocated()`) over
set-up and window, in GiB: weights, KV pool, graph pools and the
largest step's temporaries."""


def read(w):
    return w.peak_bytes / 2**30
