from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_add_noise, tree_flatten,
                                      tree_flatten_vector, tree_leaves,
                                      tree_map, tree_size, tree_unflatten,
                                      tree_unflatten_vector)
