"""Policies and head-to-head evaluation."""
