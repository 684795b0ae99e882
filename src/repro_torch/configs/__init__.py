"""Experimental configurations of the paper (simulation scale)."""
