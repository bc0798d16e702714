"""Least work and peaks: what a kernel's roofline share is measured against."""
