"""Measurement entry points of the port that run on the card."""
