"""Serving (reference ``deepspeed/inference``): the FastGen v2 ragged engine."""
