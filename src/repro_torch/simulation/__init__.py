"""Discrete-event simulator: arrivals, event queue, completion log and the
``Simulator`` that drives a policy over the serverless platform."""
