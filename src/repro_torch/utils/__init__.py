from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_flatten, tree_leaves, tree_map,
                                      tree_size, tree_unflatten)
