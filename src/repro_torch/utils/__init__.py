from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_add, tree_add_noise,
                                      tree_flatten, tree_flatten_vector,
                                      tree_l2_norm, tree_leaves, tree_map,
                                      tree_scale, tree_size, tree_sq_norm,
                                      tree_unflatten, tree_unflatten_vector,
                                      tree_weighted_sum, tree_zeros_like)
