"""Hessian (input second moment) calibration."""
