"""Inputs made from the seed: genotypes, phenotypes, a GDS file."""
