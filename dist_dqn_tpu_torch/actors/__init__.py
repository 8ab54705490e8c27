"""The Ape-X actor/learner split of the port (twin of
``dist_dqn_tpu/actors/``). The actor-side modules (``actor``, ``remote``,
``assembler``, ``act_dispatch``, ``transport``) import numpy and no torch;
``service`` owns the card."""
