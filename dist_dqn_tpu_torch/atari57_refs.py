"""Atari-57 human and random reference scores for the HNS rollup (the
port's copy of ``dist_dqn_tpu/atari57_refs.py``).

Provenance: the per-game random-play and professional-human-tester scores
of Wang et al. 2016 ("Dueling Network Architectures for Deep Reinforcement
Learning", arXiv:1511.06581, appendix), the table later Atari-57 papers
(Rainbow, Ape-X, R2D2, Agent57) normalise against, transcribed from the
literature. ``atari57.py --scores-json`` replaces it for another reference.

Format, as ``--scores-json``: {game: {"random": r, "human": h}}, with
HNS = 100 * (s - r) / (h - r).
"""
from __future__ import annotations

HUMAN_RANDOM_SCORES = {
    "Alien":            {"random": 227.8,    "human": 7127.7},
    "Amidar":           {"random": 5.8,      "human": 1719.5},
    "Assault":          {"random": 222.4,    "human": 742.0},
    "Asterix":          {"random": 210.0,    "human": 8503.3},
    "Asteroids":        {"random": 719.1,    "human": 47388.7},
    "Atlantis":         {"random": 12850.0,  "human": 29028.1},
    "BankHeist":        {"random": 14.2,     "human": 753.1},
    "BattleZone":       {"random": 2360.0,   "human": 37187.5},
    "BeamRider":        {"random": 363.9,    "human": 16926.5},
    "Berzerk":          {"random": 123.7,    "human": 2630.4},
    "Bowling":          {"random": 23.1,     "human": 160.7},
    "Boxing":           {"random": 0.1,      "human": 12.1},
    "Breakout":         {"random": 1.7,      "human": 30.5},
    "Centipede":        {"random": 2090.9,   "human": 12017.0},
    "ChopperCommand":   {"random": 811.0,    "human": 7387.8},
    "CrazyClimber":     {"random": 10780.5,  "human": 35829.4},
    "Defender":         {"random": 2874.5,   "human": 18688.9},
    "DemonAttack":      {"random": 152.1,    "human": 1971.0},
    "DoubleDunk":       {"random": -18.6,    "human": -16.4},
    "Enduro":           {"random": 0.0,      "human": 860.5},
    "FishingDerby":     {"random": -91.7,    "human": -38.7},
    "Freeway":          {"random": 0.0,      "human": 29.6},
    "Frostbite":        {"random": 65.2,     "human": 4334.7},
    "Gopher":           {"random": 257.6,    "human": 2412.5},
    "Gravitar":         {"random": 173.0,    "human": 3351.4},
    "Hero":             {"random": 1027.0,   "human": 30826.4},
    "IceHockey":        {"random": -11.2,    "human": 0.9},
    "Jamesbond":        {"random": 29.0,     "human": 302.8},
    "Kangaroo":         {"random": 52.0,     "human": 3035.0},
    "Krull":            {"random": 1598.0,   "human": 2665.5},
    "KungFuMaster":     {"random": 258.5,    "human": 22736.3},
    "MontezumaRevenge": {"random": 0.0,      "human": 4753.3},
    "MsPacman":         {"random": 307.3,    "human": 6951.6},
    "NameThisGame":     {"random": 2292.3,   "human": 8049.0},
    "Phoenix":          {"random": 761.4,    "human": 7242.6},
    "Pitfall":          {"random": -229.4,   "human": 6463.7},
    "Pong":             {"random": -20.7,    "human": 14.6},
    "PrivateEye":       {"random": 24.9,     "human": 69571.3},
    "Qbert":            {"random": 163.9,    "human": 13455.0},
    "Riverraid":        {"random": 1338.5,   "human": 17118.0},
    "RoadRunner":       {"random": 11.5,     "human": 7845.0},
    "Robotank":         {"random": 2.2,      "human": 11.9},
    "Seaquest":         {"random": 68.4,     "human": 42054.7},
    "Skiing":           {"random": -17098.1, "human": -4336.9},
    "Solaris":          {"random": 1236.3,   "human": 12326.7},
    "SpaceInvaders":    {"random": 148.0,    "human": 1668.7},
    "StarGunner":       {"random": 664.0,    "human": 10250.0},
    "Surround":         {"random": -10.0,    "human": 6.5},
    "Tennis":           {"random": -23.8,    "human": -8.3},
    "TimePilot":        {"random": 3568.0,   "human": 5229.2},
    "Tutankham":        {"random": 11.4,     "human": 167.6},
    "UpNDown":          {"random": 533.4,    "human": 11693.2},
    "Venture":          {"random": 0.0,      "human": 1187.5},
    "VideoPinball":     {"random": 16256.9,  "human": 17667.9},
    "WizardOfWor":      {"random": 563.5,    "human": 4756.5},
    "YarsRevenge":      {"random": 3092.9,   "human": 54576.9},
    "Zaxxon":           {"random": 32.5,     "human": 9173.3},
}
