from dist_dqn_tpu_torch.models.qnets import (CNNTorso, MLPTorso, NatureCNN,
                                             QNetwork, build_network)

__all__ = ["CNNTorso", "MLPTorso", "NatureCNN", "QNetwork", "build_network"]
