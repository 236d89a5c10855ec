"""Accelerated GTRACE-RS miner: encoding, device engine, driver."""
