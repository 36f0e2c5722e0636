"""Simulated serverless platform: latency models, the platform (cold
starts, scaling, cost) and heterogeneous fleet tiers."""
