"""The scheduling system: TOPSIS, criteria, weighting, schedulers, energy."""
