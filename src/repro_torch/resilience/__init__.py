"""Fault tolerance for training: straggler detection and elastic re-meshing."""
