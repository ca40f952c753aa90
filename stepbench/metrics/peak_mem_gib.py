"""peak_mem_gib: the most device memory the allocator held for tensors
during the window (``torch.cuda.max_memory_allocated``, reset at the
window's start), in GiB."""


def read(obs):
    return obs.peak_bytes / 2**30 if obs.peak_bytes else None
