"""The harness: cell lookup, inputs, the general traffic generator, the
trace reduction, the least-work counts and the check."""
