"""Layout planning: the paper's evaluator and GA scoring how a model's
GEMM chain splits over a grid of cards (``mcm_planner``)."""
