from dist_dqn_tpu_torch.models.qnets import (CNNTorso, ImplicitQuantileNetwork,
                                             MLPTorso, NatureCNN, NoisyDense,
                                             QNetwork, build_network)

__all__ = ["CNNTorso", "ImplicitQuantileNetwork", "MLPTorso", "NatureCNN",
           "NoisyDense", "QNetwork", "build_network"]
