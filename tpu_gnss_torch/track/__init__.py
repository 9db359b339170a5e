"""Tracking channel bank and quality estimators."""
