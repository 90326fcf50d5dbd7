"""Placement tables, device models and the policy registry."""
