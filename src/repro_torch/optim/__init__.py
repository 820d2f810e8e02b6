from repro_torch.optim.optimizers import (adam, apply_updates, fedadam_server,
                                          fedavgm_server, fedyogi_server,
                                          momentum, sgd, tree_add,
                                          tree_leaves, tree_map, tree_scale,
                                          tree_sub, tree_zeros_like, yogi)

__all__ = ["sgd", "momentum", "adam", "yogi", "fedadam_server",
           "fedavgm_server", "fedyogi_server", "apply_updates", "tree_map",
           "tree_leaves", "tree_add", "tree_sub", "tree_scale",
           "tree_zeros_like"]
