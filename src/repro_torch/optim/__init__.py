"""The port's optimizer: AdamW, clipping and the schedule of
``repro.optim``."""

from .adamw import (adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, compress_decompress, compress_init,
                    lr_schedule)
