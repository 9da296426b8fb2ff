"""repro_torch.checkpoint — npz saves of nests of tensors, on the JAX
package's on-disk layout."""
from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         read_checkpoint, save_checkpoint)
