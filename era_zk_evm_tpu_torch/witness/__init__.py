"""Witness commitments: the rolling memory-queue sponge."""
