"""Out-of-process services of the torch port: DSHGI probe streaming over
ZeroMQ XPUB/SUB (reference: src/dshgi_server.cc, src/dshgi_client.cc;
`zmq` is imported only where a socket is made) and frame/input streaming
for remote viewers over a plain TCP socket (reference:
src/frame_server.cc, src/frame_client.cc)."""
