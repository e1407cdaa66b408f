"""Param files."""
