/**
 * Pure-C smoke test: boot the embedded EventQL server (libevql_server),
 * connect with the C client (libevql_client), run a query end to end —
 * the reference's evqld.cc flow (conf → init → start → listen) driven
 * entirely through the C API.
 *
 * Exit 0 on success; prints one status line.
 */

#include <pthread.h>
#include <stdio.h>
#include <string.h>
#include <unistd.h>

#include "evql.h"

/* server API (declared here — the public header keeps the client
 * surface; server embedding is the libevql_server.so contract) */
typedef struct evql_server_s evql_server_t;
evql_server_t* evql_server_init(evql_conf_t* conf);
int evql_server_start(evql_server_t* server);
int evql_server_listen(evql_server_t* server, int kill_fd);
int evql_server_getport(evql_server_t* server);
void evql_server_shutdown(evql_server_t* server);
void evql_server_free(evql_server_t* server);
const char* evql_server_geterror(evql_server_t* server);
const char* evql_server_getconf(evql_server_t* server, const char* key);

struct listen_args {
  evql_server_t* server;
  int kill_fd;
};

static void* listen_thread(void* arg) {
  struct listen_args* la = (struct listen_args*)arg;
  evql_server_listen(la->server, la->kill_fd);
  return NULL;
}

int main(int argc, char** argv) {
  evql_conf_t* conf = evql_conf_init();
  evql_conf_set(conf, "server.listen", "127.0.0.1:0");
  /* key=value arguments go into the conf (server.device=cuda|cpu) */
  for (int i = 1; i < argc; i++) {
    char key[256];
    const char* eq = strchr(argv[i], '=');
    if (!eq || (size_t)(eq - argv[i]) >= sizeof(key)) {
      fprintf(stderr, "usage: %s [key=value ...]\n", argv[0]);
      return 2;
    }
    memcpy(key, argv[i], (size_t)(eq - argv[i]));
    key[eq - argv[i]] = 0;
    evql_conf_set(conf, key, eq + 1);
  }

  evql_server_t* server = evql_server_init(conf);
  if (!server) {
    fprintf(stderr, "init failed\n");
    return 1;
  }
  if (evql_server_start(server)) {
    fprintf(stderr, "start failed: %s\n", evql_server_geterror(server));
    return 1;
  }
  const char* policy =
      evql_server_getconf(server, "server.query_failed_shard_policy");
  if (!policy || strcmp(policy, "tolerate")) {
    fprintf(stderr, "getconf default mismatch\n");
    return 1;
  }

  int killpipe[2];
  if (pipe(killpipe)) return 1;
  struct listen_args la = {server, killpipe[0]};
  pthread_t t;
  pthread_create(&t, NULL, listen_thread, &la);

  /* wait for the listener to bind */
  int port = -1;
  for (int i = 0; i < 200 && port <= 0; i++) {
    usleep(50000);
    port = evql_server_getport(server);
  }
  if (port <= 0) {
    fprintf(stderr, "listener did not bind\n");
    return 1;
  }

  evql_client_t* client = evql_client_init();
  if (evql_client_connect(client, "127.0.0.1", (unsigned)port, "", 0)) {
    fprintf(stderr, "connect failed: %s\n", evql_client_geterror(client));
    return 1;
  }
  if (evql_query(client,
                 "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));",
                 NULL, 0)) {
    fprintf(stderr, "ddl failed: %s\n", evql_client_geterror(client));
    return 1;
  }
  evql_discard_result(client);
  if (evql_query(client, "INSERT INTO ev (t, v) VALUES (1, 40);", NULL, 0) ||
      evql_discard_result(client) < 0 ||
      evql_query(client, "INSERT INTO ev (t, v) VALUES (2, 2);", NULL, 0) ||
      evql_discard_result(client) < 0) {
    fprintf(stderr, "insert failed: %s\n", evql_client_geterror(client));
    return 1;
  }
  if (evql_query(client, "select sum(v) from ev;", NULL, 0)) {
    fprintf(stderr, "query failed: %s\n", evql_client_geterror(client));
    return 1;
  }
  const char** fields;
  size_t* lens;
  if (evql_fetch_row(client, &fields, &lens) != 1 || lens[0] != 2 ||
      memcmp(fields[0], "42", 2)) {
    fprintf(stderr, "unexpected result\n");
    return 1;
  }
  evql_client_close(client);
  evql_client_destroy(client);

  /* kill_fd becomes readable → listen returns (eventql.h contract) */
  (void)!write(killpipe[1], "x", 1);
  pthread_join(t, NULL);
  evql_server_shutdown(server);
  evql_server_free(server);
  evql_conf_free(conf);
  printf("embedded server smoke OK (port %d)\n", port);
  return 0;
}
