"""Launchers: the prefill/decode steps and the serving CLI."""
