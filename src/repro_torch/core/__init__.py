"""MPG accounting of the port: its own copies of the reference's
framework-free ``repro.core`` modules (goodput, ledger, and the exact
accumulation helpers of attribution), and the compile-time analysis on
one device (``flops``, ``hardware``, ``roofline``, ``costref``)."""
