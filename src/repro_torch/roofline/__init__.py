"""Roofline bounds of kernel launches and model steps on the H100."""
