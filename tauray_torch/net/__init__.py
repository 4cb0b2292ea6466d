"""Out-of-process services of the torch port: DSHGI probe streaming over
ZeroMQ XPUB/SUB (reference: src/dshgi_server.cc, src/dshgi_client.cc).
`zmq` is imported only where a socket is made."""
