"""The benchmark's synthetic scene, rendered on the device."""
