"""modulatedgps_tpu — a mixture-of-Gaussian-processes engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
LouieMiddle/ModulatedGPs (data association with mixtures of sparse
variational GPs).  See SURVEY.md at the repo root for the component map.
"""
from . import config, params, ops, likelihoods, models

from .config import default_float, default_jitter
from .params import Parameter, Module, print_summary
from .models import SVGP, VGP, SGP, SMGP, SMGPModified

__version__ = "0.1.0"
