"""Data parallelism over torch.distributed (the port of
piano_a2s_tpu/parallel): see ``dist``."""

from .dist import (all_reduce_, assert_ranks_agree, barrier,
                   broadcast_module_, broadcast_path, distributed_init,
                   is_initialized, is_main, local_device, local_rows,
                   rank, shutdown, step_rows, world)

__all__ = ["all_reduce_", "assert_ranks_agree", "barrier",
           "broadcast_module_", "broadcast_path", "distributed_init",
           "is_initialized", "is_main", "local_device", "local_rows",
           "rank", "shutdown", "step_rows", "world"]
