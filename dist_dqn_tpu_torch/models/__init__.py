from dist_dqn_tpu_torch.models.qnets import (CNNTorso, ImplicitQuantileNetwork,
                                             MLPTorso, NatureCNN, NoisyDense,
                                             QNetwork, build_network,
                                             member_forward, members_of,
                                             stack_networks)

__all__ = ["CNNTorso", "ImplicitQuantileNetwork", "MLPTorso", "NatureCNN",
           "NoisyDense", "QNetwork", "build_network", "member_forward",
           "members_of", "stack_networks"]
