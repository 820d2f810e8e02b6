from repro_torch.optim.optimizers import (adam, apply_updates, fedadam_server,
                                          fedavgm_server, fedyogi_server,
                                          momentum, tree_leaves, tree_map,
                                          tree_sub, tree_zeros_like, yogi)

__all__ = ["momentum", "adam", "yogi", "fedadam_server", "fedavgm_server",
           "fedyogi_server", "apply_updates", "tree_map", "tree_leaves",
           "tree_sub", "tree_zeros_like"]
