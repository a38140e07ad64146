"""Evaluation side of the port: panorama scorers, the eval model loader,
the episode policy and its runners, fixtures on the fake env, results."""
