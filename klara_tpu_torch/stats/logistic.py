"""4-parameter logistic function (counterpart of klara_tpu/stats/logistic.py):
logistic(x, a, k, b, c) = a / (1 + exp(−k·(x − b))) + c."""

import torch


def logistic(x, a=1.0, k=1.0, b=0.0, c=0.0):
    return a / (1.0 + torch.exp(-k * (x - b))) + c
