"""Native (host C++) code of the port: the RLE mask library behind a
ctypes binding, built with g++ at first use."""
