from .ckpt import (latest_checkpoint, load_checkpoint, save_checkpoint,
                   typed_key_leaves)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "typed_key_leaves"]
