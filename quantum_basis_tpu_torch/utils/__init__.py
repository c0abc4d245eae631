"""Host utilities: mixed-radix codecs and Lehmer random starts."""
