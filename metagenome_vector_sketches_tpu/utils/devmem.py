"""How much device memory a resident data structure may take."""

from __future__ import annotations

# left free for the programs' own buffers (staging chunks, fused-sweep
# candidate buffers, top-k carries) beside the resident planes or stack
HEADROOM_BYTES = 4 << 30


def device_budget(cpu_default: int) -> int:
    """This process's first device's allocator limit
    (``memory_stats()['bytes_limit']``, which on a GPU is the share of the
    card this process reserved) less HEADROOM_BYTES. Backends that report
    no memory stats (the CPU) get cpu_default."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        return cpu_default
    return max(1 << 30, int(stats["bytes_limit"]) - HEADROOM_BYTES)
